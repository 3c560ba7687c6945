#!/usr/bin/env python
"""npdsch_ue — NB-IoT downlink receiver from RAW baseband: acquire the
anchor carrier from 1.92 Msps samples (NPSS timing correlation + CFO
from the NPSS symbol structure → NSSS → MIB-NB), then receive an
NPDCCH-scheduled NPDSCH transport block (the `lib/examples/npdsch_ue.c`
analog, `ue_sync_nbiot.c` acquisition included — no grid oracle).

  python examples/npdsch_ue.py -i capture.cf32 -r 0x85   # raw cf32
  python examples/npdsch_ue.py --grids anchor_grids.npy  # aligned grids
  python examples/npdsch_ue.py --selftest   # generate raw + impair + decode

`--selftest` builds a full anchor stream (NPBCH sf0, NPDCCH sf1, NPDSCH
sf2-3, NPSS sf5, NSSS sf9), modulates it to raw samples, applies timing
offset + CFO + noise, and runs the complete sample-level receive chain —
the npdsch_enodeb.c + npdsch_ue.c loop in one process.
"""

from __future__ import annotations

import argparse

import numpy as np


def _selftest_stream(rng):
    from srsran_tpu.phy.phch.npbch import MibNb, npbch_encode_np, npbch_re_indices, put_nrs_np
    from srsran_tpu.phy.phch.npdsch import (
        NB_TBS, DciN1, npdcch_encode_np, npdsch_encode_np, npdsch_re_indices)
    from srsran_tpu.phy.sync.nbiot import put_npss_grid, put_nsss_grid

    ncell, rnti = 42, 0x85
    mib = MibNb(sfn_msb=7, op_mode=3)
    frames = np.zeros((10, 14, 12), np.complex64)
    frames[0].reshape(-1)[npbch_re_indices(ncell)] = npbch_encode_np(mib, ncell)[0]
    put_nrs_np(frames[0], ncell, 0)
    put_npss_grid(frames[5])
    put_nsss_grid(frames[9], ncell, 0)
    dci = DciN1(i_sf=1, i_tbs=4, ndi=1)
    tb = rng.integers(0, 2, NB_TBS[(dci.i_tbs, dci.i_sf)]).astype(np.uint8)
    idx = npdsch_re_indices(ncell)
    frames[1].reshape(-1)[idx] = npdcch_encode_np(dci.pack(), rnti, ncell, 1)
    put_nrs_np(frames[1], ncell, 1)
    data = npdsch_encode_np(tb, ncell, rnti, dci.i_sf, sf_idx0=2)
    for s in range(2):
        frames[2 + s].reshape(-1)[idx] = data[s]
        put_nrs_np(frames[2 + s], ncell, 2 + s)
    from srsran_tpu.phy.ue.ue_sync_nbiot import nbiot_modulate_np

    tx = nbiot_modulate_np(np.tile(frames, (4, 1, 1)))
    n = np.arange(len(tx))
    rx = tx * np.exp(2j * np.pi * 0.015 * n / 128) * np.complex64(0.8 * np.exp(-0.5j))
    rx = np.concatenate([np.zeros(1234, np.complex64), rx])
    noise = (rng.standard_normal(len(rx))
             + 1j * rng.standard_normal(len(rx))).astype(np.complex64)
    return (rx + 0.02 * noise).astype(np.complex64), rnti, tb


def main(argv=None):
    from srsran_tpu.phy.ue.ue_nbiot import nbiot_ue_acquire, nbiot_ue_rx_data
    from srsran_tpu.phy.ue.ue_sync_nbiot import nbiot_acquire_raw

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--input", help="raw cf32 capture at 1.92 Msps")
    ap.add_argument("--grids", help=".npy anchor grid stream (n_sf, 14, 12)")
    ap.add_argument("-r", "--rnti", type=lambda s: int(s, 0), default=0x85)
    ap.add_argument("--ctrl-sf", type=int, default=1, help="NPDCCH subframe index")
    ap.add_argument("--data-sf", type=int, default=2, help="first NPDSCH subframe")
    ap.add_argument("--data-len", type=int, default=2, help="NPDSCH subframe count")
    ap.add_argument("--selftest", action="store_true")
    args = ap.parse_args(argv)

    tb_expect = None
    raw = None
    if args.selftest:
        raw, rnti, tb_expect = _selftest_stream(np.random.default_rng(11))
    elif args.input:
        raw, rnti = np.fromfile(args.input, np.complex64), args.rnti
    elif args.grids:
        rx, rnti = np.load(args.grids), args.rnti
    else:
        raise SystemExit("need -i FILE, --grids FILE or --selftest")

    if raw is not None:
        res = nbiot_acquire_raw(raw)
        if res is None:
            print("no NB-IoT cell found (raw acquisition)")
            return 1
        cell, rx = res.cell, res.grids
        print(f"sync: timing {res.timing} samples, CFO {res.cfo * 15e3:+.0f} Hz, "
              f"NPSS PSR {res.psr:.1f}")
    else:
        cell = nbiot_ue_acquire(rx)
        if cell is None:
            print("no NB-IoT cell found")
            return 1
    print(f"cell: N_id_ncell = {cell.n_id_ncell}, MIB-NB sfn_msb={cell.mib.sfn_msb} "
          f"op_mode={cell.mib.op_mode} (NPSS at stream sf {cell.sf5_index})")

    dci, tb, ok = nbiot_ue_rx_data(
        rx[args.ctrl_sf], rx[args.data_sf : args.data_sf + args.data_len],
        cell, rnti, args.ctrl_sf, args.data_sf)
    if dci is None:
        print(f"no DCI N1 for RNTI {rnti:#x} in sf {args.ctrl_sf}")
        return 1
    print(f"DCI N1: i_sf={dci.i_sf} i_tbs={dci.i_tbs} ndi={dci.ndi}")
    if not ok:
        print("NPDSCH CRC failed")
        return 1
    print(f"NPDSCH TB ({len(tb)} bits) CRC OK: {np.packbits(tb).tobytes().hex()}")
    if tb_expect is not None:
        assert np.array_equal(tb, tb_expect), "selftest payload mismatch"
        print("selftest: payload matches")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
