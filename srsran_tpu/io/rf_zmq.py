"""ZMQ fake-RF — wire-compatible with the reference's `rf_zmq` device.

The reference's ZMQ RF driver (`lib/src/phy/rf/rf_zmq_imp.c:218-338`,
`rf_zmq_imp_tx.c:100-150`, `rf_zmq_imp_rx.c:30-70`) is the transport of
every srsLTE end-to-end setup (`test/run_lte.sh:303-312`).  Its protocol,
reproduced here byte-for-byte so this framework can peer with unmodified
reference binaries:

* per channel, one REQ/REP pair: the RECEIVER owns a ZMQ_REQ socket that
  connects to the peer's `tx_port`; it requests samples by sending ONE
  dummy byte 0xFF (`rf_zmq_imp_rx.c:36-44`), and the TRANSMITTER's
  ZMQ_REP socket replies with one message holding the pending baseband
  chunk;
* payload is interleaved I/Q at the BASE rate — `fc32` (complex64 pairs,
  the default) or `sc16` (int16 pairs scaled to INT16_MAX,
  `rf_zmq_imp_trx.h ZMQ_TYPE_*`, `rf_zmq_imp_rx.c:219`);
* `base_srate` defaults to 23.04 Msps (`ZMQ_BASERATE_DEFAULT_HZ`); the
  radio-facing rate divides it by an integer `decim_factor`
  (`rf_zmq_imp.c:411-428`).  TX zero-order-holds each sample
  `decim_factor` times (`rf_zmq_imp.c:880-900`); RX block-SUMS groups of
  `decim_factor` base samples (`rf_zmq_imp.c:737-760` — the loop
  accumulates without dividing, so amplitude scales by the factor);
* timestamps are integer sample counters at the base rate; a timed TX
  whose timestamp is beyond the transmitter's sample count first sends
  that many ZERO samples (`rf_zmq_tx_align`, `rf_zmq_imp_tx.c:169-183`),
  and each untimed RX advances `next_rx_ts` by the base-rate count.

`ZmqRfTx`/`ZmqRfRx` are single-channel endpoints; `ZmqRf` bundles
N channels and parses the reference's device-args string
(`rx_port=...,tx_port=...,id=enb,base_srate=23040000`).
"""

from __future__ import annotations

import numpy as np

INT16_MAX = 32767.0
ZMQ_BASERATE_DEFAULT_HZ = 23040000
ZMQ_TIMEOUT_MS = 2000


# --------------------------------------------------------------------------
# sample codec (pure functions — unit-tested against the byte layouts the
# reference source defines)
# --------------------------------------------------------------------------


def encode_fc32(x: np.ndarray) -> bytes:
    """complex64 samples → interleaved little-endian float32 I/Q."""
    return np.ascontiguousarray(x.astype(np.complex64)).tobytes()


def decode_fc32(b: bytes) -> np.ndarray:
    return np.frombuffer(b, np.complex64)


def encode_sc16(x: np.ndarray) -> bytes:
    """complex64 → interleaved int16 I/Q at INT16_MAX full scale
    (srslte_vec_convert_fi with scale 32767, rf_zmq_imp_tx.c:136)."""
    f = np.stack([x.real, x.imag], axis=-1).astype(np.float32) * INT16_MAX
    return np.clip(np.round(f), -32768, 32767).astype("<i2").tobytes()


def decode_sc16(b: bytes) -> np.ndarray:
    """int16 I/Q → complex64 at 1/INT16_MAX scale (rf_zmq_imp_rx.c:219)."""
    i = np.frombuffer(b, "<i2").astype(np.float32) / INT16_MAX
    return (i[0::2] + 1j * i[1::2]).astype(np.complex64)


_CODECS = {"fc32": (encode_fc32, decode_fc32, 8),
           "sc16": (encode_sc16, decode_sc16, 4)}


def zoh_interpolate(x: np.ndarray, factor: int) -> np.ndarray:
    """TX srate→base_srate zero-order hold (rf_zmq_imp.c:884-898)."""
    if factor == 1:
        return x
    return np.repeat(x, factor)


def sum_decimate(x: np.ndarray, factor: int) -> np.ndarray:
    """RX base_srate→srate block accumulation (rf_zmq_imp.c:745-752 —
    sums without dividing, matching the reference's gain convention)."""
    if factor == 1:
        return x
    n = len(x) // factor
    return x[: n * factor].reshape(n, factor).sum(axis=1)


def parse_rf_args(args: str) -> dict:
    """Parse the reference's device-args string: comma-separated
    `key=value`, with per-channel `key0=`, `key1=`, ... variants
    (rf_zmq_imp.c parse_string/parse_uint32 semantics)."""
    out: dict = {}
    for part in args.split(","):
        part = part.strip()
        if part and "=" in part:
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def _chan_arg(opts: dict, key: str, i: int, default=None):
    if f"{key}{i}" in opts:
        return opts[f"{key}{i}"]
    if i == 0 and key in opts:
        return opts[key]
    return default


# --------------------------------------------------------------------------
# endpoints
# --------------------------------------------------------------------------


class ZmqRfTx:
    """Transmitter side: ZMQ_REP bound to `port`; each peer request (one
    dummy byte) is answered with the next pending baseband chunk."""

    def __init__(self, port: str, base_srate: int = ZMQ_BASERATE_DEFAULT_HZ,
                 srate: int | None = None, fmt: str = "fc32",
                 timeout_ms: int = ZMQ_TIMEOUT_MS):
        import zmq

        self._ctx = zmq.Context.instance()
        self.sock = self._ctx.socket(zmq.REP)
        self.sock.bind(port)
        self.base_srate = base_srate
        self.srate = srate or base_srate
        self.timeout_ms = timeout_ms
        self.enc, _, self.sample_sz = _CODECS[fmt]
        self.nsamples = 0  # base-rate sample counter (tx_t.nsamples)

    @property
    def decim_factor(self) -> int:
        assert self.base_srate % self.srate == 0
        return self.base_srate // self.srate

    # the reference receiver rejects messages over its ring capacity and
    # kills its RX thread (rf_zmq_imp_rx.c:63, ZMQ_MAX_BUFFER_SIZE) — cap
    # every reply at the same bound so a large timed-TX gap stays interop;
    # 24.6 MB @ fc32 = ~3.07 M base samples
    MAX_BUFFER_BYTES = 24_600_000

    def _send_base(self, x_base: np.ndarray, timeout_ms=None):
        """REQ/REP exchanges: await the dummy request, reply with the
        chunk (rf_zmq_imp_tx.c:100-150) — split so no single message
        exceeds the reference receiver's buffer bound."""
        max_samps = max(1, self.MAX_BUFFER_BYTES // self.sample_sz)
        for off in range(0, max(len(x_base), 1), max_samps):
            chunk = x_base[off : off + max_samps]
            if len(chunk) == 0:
                break
            if not self.sock.poll(timeout_ms if timeout_ms is not None
                                  else self.timeout_ms):
                raise TimeoutError("no peer request within timeout")
            req = self.sock.recv()
            assert len(req) == 1, f"unexpected request of {len(req)} bytes"
            self.sock.send(self.enc(chunk))
            self.nsamples += len(chunk)

    def send(self, samples: np.ndarray, timestamp: int | None = None):
        """Transmit radio-rate samples; a future `timestamp` (base-rate
        sample index) first aligns with zeros (rf_zmq_tx_align)."""
        if timestamp is not None:
            gap = int(timestamp) - self.nsamples
            if gap < 0:
                raise ValueError(f"tx time {-gap} base samples in the past")
            if gap > 0:
                self._send_base(np.zeros(gap, np.complex64))
        self._send_base(zoh_interpolate(
            np.asarray(samples, np.complex64), self.decim_factor))

    def close(self):
        self.sock.close(0)


class ZmqRfRx:
    """Receiver side: ZMQ_REQ connected to the peer's tx `port`."""

    def __init__(self, port: str, base_srate: int = ZMQ_BASERATE_DEFAULT_HZ,
                 srate: int | None = None, fmt: str = "fc32",
                 timeout_ms: int = ZMQ_TIMEOUT_MS):
        import zmq

        self._ctx = zmq.Context.instance()
        self.sock = self._ctx.socket(zmq.REQ)
        self.sock.connect(port)
        self.base_srate = base_srate
        self.srate = srate or base_srate
        self.timeout_ms = timeout_ms
        _, self.dec, self.sample_sz = _CODECS[fmt]
        self.next_rx_ts = 0
        self._pending = np.zeros(0, np.complex64)  # base-rate leftovers

    @property
    def decim_factor(self) -> int:
        assert self.base_srate % self.srate == 0
        return self.base_srate // self.srate

    def recv(self, nsamples: int, timeout_ms=None):
        """Receive `nsamples` radio-rate samples; returns (samples,
        timestamp) with the timestamp in base-rate sample units at the
        start of the block (rf_zmq_recv_with_time_multi)."""
        ts = self.next_rx_ts
        df = self.decim_factor
        need = nsamples * df
        chunks = [self._pending]
        have = len(self._pending)
        while have < need:
            self.sock.send(b"\xff")
            if not self.sock.poll(timeout_ms if timeout_ms is not None
                                  else self.timeout_ms):
                raise TimeoutError("no transmitter reply within timeout")
            data = self.dec(self.sock.recv())
            chunks.append(data)
            have += len(data)
        base = np.concatenate(chunks)
        self._pending = base[need:]
        self.next_rx_ts += need
        return sum_decimate(base[:need], df), ts

    def close(self):
        self.sock.close(0)


class ZmqRf:
    """N-channel fake RF from a reference-style device-args string.

    >>> rf = ZmqRf("tx_port=tcp://*:2000,rx_port=tcp://localhost:2001,"
    ...            "id=ue,base_srate=23040000")
    """

    def __init__(self, args: str, nof_channels: int = 1):
        opts = parse_rf_args(args)
        self.id = opts.get("id", "zmq")
        base = int(opts.get("base_srate", ZMQ_BASERATE_DEFAULT_HZ))
        fmt_rx = opts.get("rx_format", "fc32")
        fmt_tx = opts.get("tx_format", "fc32")
        self.base_srate = base
        self.tx: list[ZmqRfTx | None] = []
        self.rx: list[ZmqRfRx | None] = []
        for i in range(nof_channels):
            tx_port = _chan_arg(opts, "tx_port", i)
            rx_port = _chan_arg(opts, "rx_port", i)
            self.tx.append(ZmqRfTx(tx_port, base, fmt=fmt_tx)
                           if tx_port else None)
            self.rx.append(ZmqRfRx(rx_port, base, fmt=fmt_rx)
                           if rx_port else None)

    def set_srate(self, srate: int):
        assert self.base_srate % int(srate) == 0, (
            f"srate {srate} must integer-divide base_srate "
            f"{self.base_srate} (rf_zmq update_rates)")
        for t in self.tx:
            if t:
                t.srate = int(srate)
        for r in self.rx:
            if r:
                r.srate = int(srate)

    def close(self):
        for s in self.tx + self.rx:
            if s:
                s.close()


# --------------------------------------------------------------------------
# radio-layer adapters: plug the fake RF under `io.radio.Radio`
# --------------------------------------------------------------------------


class ZmqSink:
    """`.write(samples)` adapter so `io.radio.Radio` can transmit over
    the fake-RF link (the reference stacks radio.cc on rf_zmq the same
    way)."""

    def __init__(self, tx: ZmqRfTx):
        self._tx = tx

    def write(self, samples):
        self._tx.send(np.asarray(samples, np.complex64))


class ZmqSource:
    """`.read(n)` adapter for `Radio(source=...)`."""

    def __init__(self, rx: ZmqRfRx):
        self._rx = rx

    def read(self, n):
        samples, _ts = self._rx.recv(n)
        return samples


def zmq_radio(args: str, srate_hz: float, nof_channels: int = 1,
              tx_max_gap: float = 0.1):
    """One-call reference-style bring-up: device-args string → a
    timestamp-aligned `Radio` speaking the wire protocol
    (`radio::init` + `srslte_rf_open_devname("zmq", args)`)."""
    from .radio import Radio

    rf = ZmqRf(args, nof_channels)
    rf.set_srate(int(srate_hz))
    sinks = [ZmqSink(t) if t else _NullSink() for t in rf.tx]
    source = ZmqSource(rf.rx[0]) if rf.rx[0] else None
    radio = Radio(sinks, source=source, srate_hz=srate_hz,
                  tx_max_gap=tx_max_gap)
    radio.rf = rf  # keep the endpoints alive / closable
    return radio


class _NullSink:
    def write(self, samples):
        pass
