#!/usr/bin/env python
"""pdsch_enodeb — generate a continuous LTE DL signal carrying PDSCH data
(the `lib/examples/pdsch_enodeb.c` analog).

Renders frames with PSS/SSS/PBCH/CRS and one full-band PDSCH grant per
subframe (frame-counter payload), writing cf32 samples to a file or UDP.

  python examples/pdsch_enodeb.py -o /tmp/dl.cf32 -p 6 -m 4 -n 4
"""

from __future__ import annotations

import argparse

import numpy as np


def build_frame(cell, rnti: int, mcs: int, sfn: int, payload_fn):
    from srsran_tpu.phy.enb.enb_dl import DlSched, enb_dl_subframe
    from srsran_tpu.phy.phch.dci import Dci1A
    from srsran_tpu.phy.phch.pbch import Mib
    from srsran_tpu.phy.phch.pdsch import DlGrant
    from srsran_tpu.phy.phch.pdcch import nof_cce, search_space_candidates
    from srsran_tpu.phy.phch.ra import dl_mcs_to_mod, dl_tbs, riv_encode

    mib = Mib(nof_prb=cell.nof_prb)
    out = []
    tbs_sent = []
    for sf_idx in range(10):
        riv = riv_encode(cell.nof_prb, 0, cell.nof_prb)
        dci = Dci1A(riv=riv, mcs=mcs, harq_pid=0, ndi=1, rv=0)
        grant = DlGrant(
            prb=tuple(range(cell.nof_prb)),
            mod=dl_mcs_to_mod(mcs),
            tbs=dl_tbs(mcs, cell.nof_prb),
            rnti=rnti,
        )
        tb = payload_fn(sfn, sf_idx, grant.tbs)
        cands = search_space_candidates(rnti, sf_idx, nof_cce(cell, sf_idx, 1))
        agg = 4 if cands.get(4) else max(cands)
        sched = DlSched(
            cfi=1,
            dcis=[(dci.pack(cell.nof_prb), rnti, agg, cands[agg][0])],
            grants=[(grant, tb)],
        )
        _, samples = enb_dl_subframe(cell, sf_idx, sched, mib=mib, sfn=sfn)
        out.append(samples[0])
        tbs_sent.append(tb)
    return np.concatenate(out), tbs_sent


def counter_payload(sfn: int, sf_idx: int, tbs: int) -> np.ndarray:
    """Deterministic frame/subframe-seeded payload (stands in for the
    reference's byte counter)."""
    rng = np.random.default_rng(sfn * 10 + sf_idx)
    return rng.integers(0, 2, tbs).astype(np.uint8)


def main(argv=None):
    from srsran_tpu.io import FileSink, NetSink
    from srsran_tpu.phy.common import Cell

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-o", "--output", required=True, help="cf32 file path or udp:host:port")
    ap.add_argument("-p", "--nof-prb", type=int, default=6)
    ap.add_argument("-c", "--cell-id", type=int, default=1)
    ap.add_argument("-m", "--mcs", type=int, default=4)
    ap.add_argument("-r", "--rnti", type=lambda s: int(s, 0), default=0x1234)
    ap.add_argument("-n", "--nof-frames", type=int, default=1)
    args = ap.parse_args(argv)

    cell = Cell(nof_prb=args.nof_prb, nof_ports=1, id=args.cell_id)
    if args.output.startswith("udp:"):
        _, host, port = args.output.split(":")
        sink = NetSink(host, int(port))
    else:
        sink = FileSink(args.output)
    for sfn in range(args.nof_frames):
        frame, _ = build_frame(cell, args.rnti, args.mcs, sfn, counter_payload)
        sink.write(frame.astype(np.complex64))
        print(f"sfn {sfn}: {len(frame)} samples", flush=True)
    sink.close()


if __name__ == "__main__":
    main()
