#!/usr/bin/env python
"""Three-process LTE E2E over REAL sockets — the analog of the
reference's `test/run_lte.sh:288-312` process topology:

  UE proc  <-- PHY I/Q frames (TCP lockstep, the rf_zmq REQ/REP
               pattern, rf_zmq_imp.c:218) -->  eNB proc
  eNB proc <-- S1AP over TCP :36412 with 4-byte length framing (a
               documented SCTP stand-in; srsepc/src/mme/mme.cc:25
               listens on SCTP) + GTP-U over UDP :2152
               (srsenb/src/stack/upper/gtpu.cc) -->  EPC proc

Every byte that crosses a process boundary is the real wire format the
conformance tests check (S1AP ALIGNED-PER, GTP-U headers, complex64
I/Q).  Run each role:

  python apps/run_lte_3proc.py --role epc --s1ap-port 36412 --gtpu-port 2152
  python apps/run_lte_3proc.py --role enb --s1ap 127.0.0.1:36412 \
      --gtpu 127.0.0.1:2152 --phy-port 2300
  python apps/run_lte_3proc.py --role ue --phy 127.0.0.1:2300

With `--tun` (root): the UE attaches a kernel TUN inside a netns and
the EPC raises the SGi TUN + runs a real `ping` through the whole
stack, exactly like run_lte.sh.  Each role prints one JSON result line.
"""

import argparse
import json
import os
import socket
import struct
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import jax

# per-TTI host reference path, on the CPU: the launchers run several
# JAX processes at once, and a JAX process on a GPU reserves most of
# the card's memory when it starts, so two of them cannot share a card
jax.config.update("jax_platforms", "cpu")

import numpy as np

IMSI = "001010123456789"
KEY = bytes.fromhex("00112233445566778899aabbccddeeff")


def _frame_send(sock: socket.socket, data: bytes):
    sock.sendall(struct.pack(">I", len(data)) + data)


def _frame_recv(sock: socket.socket) -> bytes | None:
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    n = struct.unpack(">I", hdr)[0]
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            return None
        out += chunk
    return out


def _drain_frames(sock: socket.socket, out: list):
    """Nonblocking: append any complete frames queued on `sock`."""
    sock.setblocking(False)
    try:
        while True:
            sock.setblocking(True)
            sock.settimeout(0.0005)
            try:
                msg = _frame_recv(sock)
            except (socket.timeout, BlockingIOError):
                return
            if msg is None:
                return
            out.append(msg)
    finally:
        sock.setblocking(True)
        sock.settimeout(None)


# ==========================================================================
# EPC process: MME + HSS + SPGW behind real listeners
# ==========================================================================


def run_epc(args):
    from srsran_tpu.epc import Hss, Mme, Spgw, Subscriber
    from srsran_tpu.stack import security as sec

    opc = sec.compute_opc(KEY, bytes.fromhex(
        "63bfa50ee6523365ff14c1f45f88737d"))
    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", IMSI, KEY, opc, amf=b"\x80\x00",
                                  sqn=0))
    spgw = Spgw()
    mme = Mme(hss, spgw)

    # S1AP: TCP with length framing — the SCTP stand-in (mme.cc:25)
    ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    ls.bind(("127.0.0.1", args.s1ap_port))
    ls.listen(1)
    # GTP-U: the real UDP:2152 (gtpu.cc)
    gu = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    gu.bind(("127.0.0.1", args.gtpu_port))
    gu.setblocking(False)
    print(json.dumps({"epc": "listening"}), flush=True)

    conn, _addr = ls.accept()
    enb_gtpu_addr = None
    if args.tun:
        spgw.attach_tun(name="tun_sgi3p")
    dl_sent = 0
    # the duration clock starts at the first UE attach: the peers spend
    # an unbounded machine-dependent stretch in import + first-TTI jit
    # tracing, and a wall deadline from process start makes the run
    # length a startup lottery (hard cap keeps a stuck run bounded)
    t_end = None
    t_hard = time.time() + args.duration + 120.0
    attached_ip = None
    last_dl = 0.0
    while (t_end is None or time.time() < t_end) and time.time() < t_hard:
        msgs: list = []
        _drain_frames(conn, msgs)
        for m in msgs:
            for resp in mme.handle(m, enb_id=0x19B):
                _frame_send(conn, resp)
        mme.pump_s11()
        try:
            while True:
                pkt, addr = gu.recvfrom(65536)
                enb_gtpu_addr = addr
                spgw.rx_from_enb(pkt)
        except BlockingIOError:
            pass
        while (pkt := spgw.pop_tx()) is not None and enb_gtpu_addr:
            gu.sendto(pkt, enb_gtpu_addr)
        if args.tun:
            spgw.pump_tun()
        if attached_ip is None and mme.attached_imsis:
            for ue in mme.ues.values():
                if ue.ue_ip:
                    attached_ip = ue.ue_ip
            if attached_ip is not None and t_end is None:
                t_end = time.time() + args.duration
        if (attached_ip and dl_sent < args.n_dl and not args.tun
                and time.time() - last_dl > 0.01):
            # synthetic DL payloads (host-queue mode only: with --tun
            # the traffic is the real kernel ICMP)
            spgw.sgi_tx(attached_ip, bytes([dl_sent & 0xFF]) * 120)
            dl_sent += 1
            last_dl = time.time()
        time.sleep(0.001)
    print(json.dumps({
        "role": "epc", "attached": sorted(mme.attached_imsis),
        "ue_ip": attached_ip, "dl_sent": dl_sent,
        "sgi_rx": len(spgw.sgi_rx),
    }), flush=True)


# ==========================================================================
# eNB process: full EnbStack with socket proxies toward the EPC
# ==========================================================================


class MmeProxy:
    """The EnbStack-facing MME handle whose transport is the S1AP
    socket: `handle()` writes frames, inbound frames are pumped back
    into the stack's registered link (s1ap.cc role)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._link = None

    def register_enb(self, enb_id: int, link):
        self._link = link

    def handle(self, msg: bytes, enb_id: int | None = None) -> list:
        _frame_send(self.sock, msg)
        return []  # responses arrive asynchronously via pump()

    def pump(self):
        msgs: list = []
        _drain_frames(self.sock, msgs)
        for m in msgs:
            if self._link is not None:
                self._link(m)


class SpgwProxy:
    """The EnbStack-facing S1-U handle: GTP-U PDUs cross UDP:2152 in
    both directions (gtpu.cc)."""

    def __init__(self, addr):
        from collections import deque

        self.addr = addr
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.setblocking(False)
        self.tx_queue = deque()  # local requeue buffer (_pump_spgw holds
        #                          packets for not-yet-active bearers)

    def rx_from_enb(self, pkt: bytes):
        self.sock.sendto(pkt, self.addr)

    def pop_tx(self):
        if self.tx_queue:
            return self.tx_queue.popleft()
        try:
            pkt, _ = self.sock.recvfrom(65536)
            return pkt
        except BlockingIOError:
            return None


def run_enb(args):
    from srsran_tpu.apps.full_stack import EnbStack
    from srsran_tpu.phy.common import Cell

    host, port = args.s1ap.split(":")
    s1 = socket.create_connection((host, int(port)))
    ghost, gport = args.gtpu.split(":")
    mme = MmeProxy(s1)
    spgw = SpgwProxy((ghost, int(gport)))
    cell = Cell(nof_prb=args.prb, nof_ports=1, id=7)
    enb = EnbStack(cell, mme, spgw, mcs=8)

    ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    ls.bind(("127.0.0.1", args.phy_port))
    ls.listen(1)
    print(json.dumps({"enb": "listening"}), flush=True)
    conn, _ = ls.accept()

    ul = None
    n_tti = 0
    # clock from the first completed TTI exchange (see run_epc note)
    t_end = None
    t_hard = time.time() + args.duration + 120.0
    while (t_end is None or time.time() < t_end) and time.time() < t_hard:
        if t_end is None and n_tti >= 1:
            t_end = time.time() + args.duration
        mme.pump()
        dl = enb.run_tti(ul)
        # PHY frame toward the UE (REQ/REP lockstep, rf_zmq pattern);
        # the peer may have hit its own deadline — exit on a closed link
        try:
            _frame_send(conn, np.ascontiguousarray(
                dl, np.complex64).tobytes())
            fr = _frame_recv(conn)
        except OSError:
            break
        if fr is None:
            break
        ul = (np.frombuffer(fr, np.complex64).copy() if fr else None)
        n_tti += 1
    print(json.dumps({
        "role": "enb", "ttis": n_tti,
        "ul_crc_ok": enb.stats.get("ul_crc_ok", 0),
        "ues": [hex(r) for r in enb.ues],
    }), flush=True)


# ==========================================================================
# UE process
# ==========================================================================


def run_ue(args):
    from srsran_tpu.apps.full_stack import UeStack
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.stack import security as sec
    from srsran_tpu.stack.nas_ue import Usim

    opc = sec.compute_opc(KEY, bytes.fromhex(
        "63bfa50ee6523365ff14c1f45f88737d"))
    cell = Cell(nof_prb=args.prb, nof_ports=1, id=7)
    ue = UeStack(cell, Usim(IMSI, KEY, opc))
    host, port = args.phy.split(":")
    for _ in range(100):
        try:
            sock = socket.create_connection((host, int(port)))
            break
        except OSError:
            time.sleep(0.1)
    ul_sent = 0
    ping_proc = None
    ping_out = ""
    n_rx = 0
    # clock from the first completed TTI exchange (see run_epc note)
    t_end = None
    t_hard = time.time() + args.duration + 120.0
    while (t_end is None or time.time() < t_end) and time.time() < t_hard:
        if t_end is None and n_rx >= 1:
            t_end = time.time() + args.duration
        try:
            fr = _frame_recv(sock)
        except OSError:
            break
        if fr is None:
            break
        dl = np.frombuffer(fr, np.complex64).copy()
        ul = ue.run_tti(dl)
        try:
            _frame_send(sock, b"" if ul is None else np.ascontiguousarray(
                ul, np.complex64).tobytes())
        except OSError:
            break
        n_rx += 1
        if (ue.rrc_state == UeStack.RRC_ACTIVE
                and ue.nas.state == ue.nas.REGISTERED):
            if args.tun and ping_proc is None:
                # kernel IP boundary in a netns + a real ping toward the
                # SGi gateway — the run_lte.sh:288-312 procedure
                import subprocess

                gw = ue.attach_tun(name="tun_ue3p", netns=args.netns)
                gw.tun.add_route("default")
                pkg = os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__)))
                # the ping child is another JAX process: keep it off the
                # card, whose memory the first JAX process there reserves
                env = dict(os.environ, PYTHONPATH=pkg,
                           JAX_PLATFORMS="cpu")
                ping_proc = subprocess.Popen(
                    ["ip", "netns", "exec", args.netns, "python", "-m",
                     "srsran_tpu.io.icmp_ping", "172.16.0.254", "3",
                     "40"],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True, env=env)
            if ul_sent < args.n_ul and not args.tun:
                ue.send_ip_packet(bytes([0x45, ul_sent & 0xFF]) * 60)
                ul_sent += 1
    ping_rc = None
    if ping_proc is not None:
        try:
            ping_out, _ = ping_proc.communicate(timeout=10)
        except Exception:
            ping_proc.kill()
        ping_rc = ping_proc.returncode
    print(json.dumps({
        "role": "ue", "registered": ue.nas.state == ue.nas.REGISTERED,
        "ue_ip": ue.ue_ip, "ip_rx": len(ue.ip_rx), "ul_sent": ul_sent,
        "ping_rc": ping_rc, "ping_out": ping_out[-200:],
    }), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", required=True, choices=("epc", "enb", "ue"))
    ap.add_argument("--s1ap-port", type=int, default=36412)
    ap.add_argument("--gtpu-port", type=int, default=2152)
    ap.add_argument("--s1ap", default="127.0.0.1:36412")
    ap.add_argument("--gtpu", default="127.0.0.1:2152")
    ap.add_argument("--phy", default="127.0.0.1:2300")
    ap.add_argument("--phy-port", type=int, default=2300)
    ap.add_argument("--prb", type=int, default=15)
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--n-dl", type=int, default=12)
    ap.add_argument("--n-ul", type=int, default=6)
    ap.add_argument("--tun", action="store_true")
    ap.add_argument("--netns", default="srstpu_3p")
    args = ap.parse_args()
    {"epc": run_epc, "enb": run_enb, "ue": run_ue}[args.role](args)


if __name__ == "__main__":
    main()
