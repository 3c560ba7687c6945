#!/usr/bin/env python
"""pdsch_ue — receive an LTE DL signal, search for the cell, decode MIB and
then PDSCH every subframe (the `lib/examples/pdsch_ue.c` analog).

  python examples/pdsch_ue.py -i /tmp/dl.cf32 -p 6 -r 0x1234 --scope /tmp

With --scope DIR, dumps constellation/channel PNGs (the srsGUI analog).
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    from srsran_tpu.io import FileSource, NetSource
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.ofdm import OfdmConfig
    from srsran_tpu.phy.ue.ue_dl import ue_dl_decode_subframe
    from srsran_tpu.phy.ue.ue_sync import apply_cfo, cell_search, mib_search

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--input", required=True, help="cf32 file path or udp:host:port")
    ap.add_argument("-p", "--nof-prb", type=int, default=6)
    ap.add_argument("-r", "--rnti", type=lambda s: int(s, 0), default=0x1234)
    ap.add_argument("-n", "--nof-frames", type=int, default=0, help="0 = whole input")
    ap.add_argument("--scope", default=None, help="directory for scope PNGs")
    args = ap.parse_args(argv)

    if args.input.startswith("udp:"):
        _, host, port = args.input.split(":")
        src = NetSource(host, int(port))
    else:
        src = FileSource(args.input)

    cell0 = Cell(nof_prb=args.nof_prb, nof_ports=1, id=0)
    frame_len = cell0.sf_len * 10
    head = src.read(frame_len * 2)

    res = cell_search(head, args.nof_prb)
    if res is None:
        print("no cell found")
        return 1
    print(f"cell found: id={res.cell_id} cfo={res.cfo:.3f} sf_idx={res.sf_idx}")
    cell = Cell(nof_prb=args.nof_prb, nof_ports=1, id=res.cell_id)
    ofdm = OfdmConfig.from_cell(cell)
    sf0 = res.peak_offset - ofdm.symbol_starts()[6] + (cell.sf_len * 5 if res.sf_idx == 5 else 0)
    got = mib_search(head, cell, sf0, res.cfo)
    if got is None:
        print("MIB decode failed")
        return 1
    mib, nports, _ = got
    print(f"MIB: nof_prb={mib.nof_prb} ports={nports} sfn={mib.sfn}")

    stream = apply_cfo(head[sf0:], -res.cfo, cell.symbol_sz)
    n_ok = n_tb = 0
    scope = None
    if args.scope:
        from srsran_tpu.runtime.plots import LiveScope

        scope = LiveScope(f"{args.scope}/pdsch_const.png", period_s=0.0)
    sf_count = len(stream) // cell.sf_len
    if args.nof_frames:
        sf_count = min(sf_count, args.nof_frames * 10)
    for t in range(sf_count):
        sf = stream[t * cell.sf_len : (t + 1) * cell.sf_len]
        r = ue_dl_decode_subframe(cell, sf[None, :], t % 10, args.rnti)
        for tb, ok in r.tbs:
            n_tb += 1
            n_ok += int(ok)
        if scope is not None and r.pdsch_symbols is not None:
            scope.update(r.pdsch_symbols)
        if t % 10 == 9:
            print(
                f"sfn~{t//10}: PDSCH {n_ok}/{n_tb} ok, SNR {r.snr_db:.1f} dB, noise {r.noise:.2e}",
                flush=True,
            )
    print(f"total: {n_ok}/{n_tb} transport blocks CRC-OK")
    return 0 if n_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
