#!/usr/bin/env python
"""srsran_tpu UE process: ingests I/Q over UDP (native GIL-free pump),
synchronizes, decodes, and prints received data-bearer SDUs.

Analog of the reference `srsue` binary on the ZMQ fake RF. Usage:

  python apps/ue_app.py --port 2101 --phy.nof_prb=6 --duration 5
"""

import argparse
import sys
import time

sys.path.insert(0, ".")
# per-TTI host reference path, on the CPU: the launchers run several
# JAX processes at once, and a JAX process on a GPU reserves most of
# the card's memory when it starts, so two of them cannot share a card
import jax
jax.config.update("jax_platforms", "cpu")

from srsran_tpu.apps.ue import UeApp
from srsran_tpu.native import SampleRing
from srsran_tpu.phy.common import Cell
from srsran_tpu.runtime import MetricsHub, StdoutMetrics, load_config


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--port", type=int, default=2101)
    ap.add_argument("--duration", type=float, default=5.0)
    args, extra = ap.parse_known_args()
    cfg = load_config(args.config, overrides=extra)

    ue = UeApp(nof_prb=cfg.phy.nof_prb, rnti=cfg.rnti, cfi=cfg.phy.cfi or None,
               pcap_path=cfg.pcap.filename if cfg.pcap.enable else None)
    cell0 = Cell(nof_prb=cfg.phy.nof_prb)
    ring = SampleRing(64 * cell0.sf_len)
    ring.start_udp_pump(args.port)

    hub = MetricsHub()
    hub.add_producer(ue.get_metrics)
    hub.add_listener(StdoutMetrics())

    t_end = time.time() + args.duration
    n_sdu = 0
    while time.time() < t_end:
        chunk = ring.read(cell0.sf_len, timeout_s=0.2)
        if len(chunk):
            ue.push_samples(chunk)
            ue.process()
        while True:
            sdu = ue.read_sdu()
            if sdu is None:
                break
            n_sdu += 1
            print(f"SDU {n_sdu}: {sdu[:24]!r}... ({len(sdu)} B)", flush=True)
    hub.poll_once()
    print(f"done: {n_sdu} SDUs, dropped_samples={ring.dropped}", flush=True)
    ring.close()


if __name__ == "__main__":
    main()
