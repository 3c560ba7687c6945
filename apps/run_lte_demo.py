#!/usr/bin/env python
"""Single-host full-stack LTE demo: UE <-> eNB <-> MME/SPGW with a complete
attach (PRACH/RAR/RRC/NAS-auth/AS-security/DRB) and a bidirectional ping
over the OFDM/turbo PHY — the executable analog of the reference's
`test/run_lte.sh` E2E smoke.

  python apps/run_lte_demo.py [--prb 15] [--snr 25]
  python apps/run_lte_demo.py --tun        # REAL kernel ICMP ping through
                                           # the stack (root; netns like
                                           # run_lte.sh:288)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, ".")
import jax

# per-TTI host reference path, on the CPU: with --tun it starts a second
# JAX process (the ping), and a JAX process on a GPU reserves most of the
# card's memory when it starts, so two of them cannot share a card
jax.config.update("jax_platforms", "cpu")

import numpy as np

from srsran_tpu.apps.full_stack import EnbStack, UeStack
from srsran_tpu.epc import Hss, Mme, Spgw, Subscriber
from srsran_tpu.phy.common import Cell
from srsran_tpu.stack import security as sec
from srsran_tpu.stack.nas_ue import Usim

IMSI = "001010123456789"
KEY = bytes.fromhex("00112233445566778899aabbccddeeff")
OPC = sec.compute_opc(KEY, bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--prb", type=int, default=15)
    ap.add_argument("--snr", type=float, default=None, help="add AWGN at this SNR (dB)")
    ap.add_argument("--pings", type=int, default=4)
    ap.add_argument("--tun", action="store_true",
                    help="kernel IP boundary: UE TUN in a netns + SPGW SGi "
                         "TUN, ping with srsran_tpu.io.icmp_ping")
    args = ap.parse_args()

    cell = Cell(nof_prb=args.prb, nof_ports=1, id=7)
    hss = Hss()
    hss.add_subscriber(Subscriber("demo", IMSI, KEY, OPC, amf=b"\x80\x00", sqn=0))
    spgw = Spgw()
    mme = Mme(hss, spgw)
    enb = EnbStack(cell, mme, spgw, mcs=5)
    ue = UeStack(cell, Usim(IMSI, KEY, OPC))
    rng = np.random.default_rng(0)

    t0 = time.time()
    ul = None
    attached_at = None
    for tti in range(400):
        dl = enb.run_tti(ul)
        if args.snr is not None:
            p = np.mean(np.abs(dl) ** 2) or 1.0
            n0 = np.sqrt(p * 10 ** (-args.snr / 10) / 2)
            dl = dl + (rng.standard_normal(len(dl)) + 1j * rng.standard_normal(len(dl))).astype(np.complex64) * n0
        ul = ue.run_tti(dl)
        if attached_at is None and ue.nas.state == ue.nas.REGISTERED and ue.rrc_state == UeStack.RRC_ACTIVE:
            attached_at = tti
            print(f"[{tti} ms] ATTACHED  ip={ue.ue_ip}  (prach->registered in {tti} TTIs)")
            for i in range(args.pings):
                spgw.sgi_tx(ue.ue_ip, bytes([0x45, i]) + b"ping" * 8)
        if attached_at is not None and len(ue.ip_rx) == args.pings and not ue.ip_tx_queue:
            if not hasattr(main, "_up"):
                main._up = True
                print(f"[{tti} ms] DL ping: {len(ue.ip_rx)}/{args.pings} received")
                for i, p in enumerate(ue.ip_rx):
                    ue.send_ip_packet(bytes([0x45, 0x80 + i]) + b"pong" * 8)
        if len(spgw.sgi_rx) >= args.pings:
            print(f"[{tti} ms] UL pong: {len(spgw.sgi_rx)}/{args.pings} received at SGi")
            break
    assert attached_at is not None, "attach failed"

    if args.tun:
        import subprocess

        from srsran_tpu.io.tun import TunDevice

        assert TunDevice.available(), "environment forbids TUN"
        ns = "srstpu_demo"
        subprocess.run(["ip", "netns", "del", ns], capture_output=True)
        subprocess.run(["ip", "netns", "add", ns], check=True)
        try:
            spgw.attach_tun(name="tun_sgi_demo")
            gw = ue.attach_tun(name="tun_ue_demo", netns=ns)
            gw.tun.add_route("default")
            pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            # the ping child is a second JAX process: keep it off the card
            env = dict(os.environ, PYTHONPATH=pkg_root, JAX_PLATFORMS="cpu")
            ping = subprocess.Popen(
                ["ip", "netns", "exec", ns, "python", "-m",
                 "srsran_tpu.io.icmp_ping", "172.16.0.254", str(args.pings), "40"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            deadline = time.time() + 90
            while ping.poll() is None and time.time() < deadline:
                dl = enb.run_tti(ul)
                ul = ue.run_tti(dl)
                spgw.pump_tun()
            out, _ = ping.communicate(timeout=10)
            print("[kernel ping]", out.strip().replace(chr(10), chr(10) + "  "))
            assert ping.returncode == 0, "kernel ping failed"
        finally:
            if ue.gw:
                ue.gw.close()
            if spgw.sgi_tun:
                spgw.sgi_tun.close()
            subprocess.run(["ip", "netns", "del", ns], capture_output=True)

    print(f"done in {time.time()-t0:.1f}s wall  |  eNB {enb.get_metrics()}  |  UE {ue.get_metrics()}")


if __name__ == "__main__":
    main()
