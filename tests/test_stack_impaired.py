"""Full-stack E2E under channel impairment: attach
and pass IP traffic through EPA fading + AWGN at moderate SNR in BOTH
directions — the reference proves its worth over the air, not on clean
channels (`lib/src/phy/channel/fading.c` is exactly for this).
"""

import jax
import numpy as np
import pytest

from srsran_tpu.apps.full_stack import EnbStack, UeStack
from srsran_tpu.epc import Hss, Mme, Spgw, Subscriber
from srsran_tpu.phy.channel.fading import FadingConfig, apply_fading, awgn
from srsran_tpu.phy.common import Cell
from srsran_tpu.stack import security as sec
from srsran_tpu.stack.nas_ue import Usim

IMSI = "001010123456789"
KEY = bytes.fromhex("00112233445566778899aabbccddeeff")
OPC = sec.compute_opc(KEY, bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d"))


class _Air:
    """Bidirectional impaired link: independent EPA fades per direction,
    block fading per subframe, AWGN at a fixed SNR."""

    def __init__(self, srate, snr_db=15.0, doppler_hz=5.0):
        self.dl = FadingConfig(model="epa", doppler_hz=doppler_hz, srate=srate, seed=1)
        self.ul = FadingConfig(model="epa", doppler_hz=doppler_hz, srate=srate, seed=2)
        self.snr_db = snr_db
        self.t = 0.0
        self.key = jax.random.PRNGKey(7)

    def _step_key(self):
        self.key, k = jax.random.split(self.key)
        return k

    def fwd(self, cfg, x):
        if x is None:
            return None
        y, _h = apply_fading(cfg, x, t0_seconds=self.t)
        p = float(np.mean(np.abs(np.asarray(y)) ** 2) + 1e-12)
        self.pow_db = getattr(self, "pow_db", [])
        self.pow_db.append(10.0 * np.log10(p))
        y = awgn(self._step_key(), y, self.snr_db)
        return np.asarray(y)

    def tick(self, dt_s=1e-3):
        self.t += dt_s


def test_attach_and_traffic_through_epa_fading():
    cell = Cell(nof_prb=15, nof_ports=1, id=7)
    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", IMSI, KEY, OPC, amf=b"\x80\x00", sqn=0))
    spgw = Spgw()
    mme = Mme(hss, spgw)
    enb = EnbStack(cell, mme, spgw, mcs=4)  # conservative MCS at 15 dB faded
    ue = UeStack(cell, Usim(IMSI, KEY, OPC))
    air = _Air(srate=cell.sf_len * 1e3, snr_db=12.0)

    ul = None
    attached_at = None
    for tti in range(400):
        dl = enb.run_tti(air.fwd(air.ul, ul))
        ul = ue.run_tti(air.fwd(air.dl, dl))
        air.tick()
        if (attached_at is None and ue.rrc_state == UeStack.RRC_ACTIVE
                and ue.nas.state == ue.nas.REGISTERED):
            attached_at = tti
            break
    assert attached_at is not None, "attach failed through EPA fading @12 dB"

    # bidirectional IP traffic through the fade; HARQ carries the dips
    dl_pkts = [bytes([0x30 + i]) * 40 for i in range(4)]
    for p in dl_pkts:
        spgw.sgi_tx(ue.ue_ip, p)
    ul_pkts = [bytes([0x50 + i]) * 40 for i in range(3)]
    for p in ul_pkts:
        ue.send_ip_packet(p)
    for _ in range(250):
        dl = enb.run_tti(air.fwd(air.ul, ul))
        ul = ue.run_tti(air.fwd(air.dl, dl))
        air.tick()
        if len(ue.ip_rx) >= len(dl_pkts) and len(spgw.sgi_rx) >= len(ul_pkts):
            break
    assert ue.ip_rx[: len(dl_pkts)] == dl_pkts, "DL traffic lost in the fade"
    got_ul = [pl for _, pl in spgw.sgi_rx]
    assert got_ul[: len(ul_pkts)] == ul_pkts, "UL traffic lost in the fade"
    # the link was genuinely impaired: the EPA process swung the received
    # power by several dB (frequency-selective, Doppler-evolving), and the
    # closed-loop TPC reacted to the UL fades
    swing = max(air.pow_db) - min(air.pow_db)
    assert swing > 3.0, f"channel barely faded ({swing:.1f} dB swing)"
    assert abs(ue.ul_gain_db) > 0.5, "TPC never reacted to the fading" 
