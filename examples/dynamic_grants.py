#!/usr/bin/env python
"""Dynamic-grant pipeline demo: decode a random scheduler-driven grant mix
(MCS 0-28 x arbitrary PRB allocations x all subframes) through ONE bounded
set of pre-compiled programs — the batched answer to the reference's
per-TTI-arbitrary-grant property (srsue/src/phy/cc_worker.cc:214-307).

  python examples/dynamic_grants.py [--prb 50] [--ttis 30]
  python examples/dynamic_grants.py --window 8   # W TTIs per dispatch,
                                                 # ONE fixed program set
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
from srsran_tpu.phy.common import Cell
from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
from srsran_tpu.phy.phch.pdsch import DlGrant, pdsch_encode_np
from srsran_tpu.phy.phch.ra import dl_mcs_to_mod, dl_tbs
from srsran_tpu.pipeline_dynamic import DynamicUeDl


def _random_grant(rng, cell, ofdm, prb_max):
    while True:
        sf_idx = int(rng.integers(0, 10))
        mcs = int(rng.integers(0, 29))
        l = int(rng.integers(1, prb_max + 1))
        st = int(rng.integers(0, prb_max + 1 - l))
        tbs = dl_tbs(mcs, l)
        if tbs == 0:
            continue
        grant = DlGrant(prb=tuple(range(st, st + l)), mod=dl_mcs_to_mod(mcs),
                        tbs=tbs, rnti=0x46)
        tb = rng.integers(0, 2, tbs).astype(np.uint8)
        grid = pdsch_encode_np(cell, sf_idx, 1, grant, tb)
        put_crs_np(grid, cell, sf_idx)
        tx = np.asarray(ofdm_tx_sf(ofdm, grid))[0]
        rx = (tx + 0.05 * (rng.standard_normal(tx.shape)
                           + 1j * rng.standard_normal(tx.shape))).astype(np.complex64)
        return rx, sf_idx, mcs, st, l, grant, tb


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--prb", type=int, default=50)
    ap.add_argument("--ttis", type=int, default=30)
    ap.add_argument("--window", type=int, default=0,
                    help="decode W TTIs per dispatch (pipeline_window)")
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    cell = Cell(nof_prb=args.prb, nof_ports=1, id=17)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)

    if args.window:
        from srsran_tpu.pipeline_window import WindowedUeDl

        W = args.window
        ue = WindowedUeDl(cell, cfi=1, w=W)
        n_ok = bits = ttis = 0
        t0 = time.time()
        for wi in range((args.ttis + W - 1) // W):
            mix = [_random_grant(rng, cell, ofdm, args.prb) for _ in range(W)]
            samples = np.stack([m[0] for m in mix])[:, None, :]
            res, _ = ue.decode_window(samples, [m[1] for m in mix],
                                      [m[5] for m in mix])
            for m, r in zip(mix, res):
                _, sf_idx, mcs, st, l, grant, tb = m
                tb_hat, ok, n_it = r
                n_ok += int(ok and (tb_hat == tb).all())
                bits += grant.tbs
                ttis += 1
                print(f"tti {ttis:3d}  sf {sf_idx}  mcs {mcs:2d}  "
                      f"prb [{st:3d},{st+l:3d})  tbs {grant.tbs:6d}  "
                      f"{'OK' if ok else 'KO'} it={n_it}")
        dt = time.time() - t0
        print(f"\n{n_ok}/{ttis} grants decoded in {ttis//W} windows of {W}, "
              f"{bits/1e6:.2f} Mbit, {dt:.1f}s wall — fixed stage A/B programs "
              f"+ one dense stage C per occupancy bucket, ANY grant mix")
        return

    ue = DynamicUeDl(cell, cfi=1)
    n_ok = 0
    bits = 0
    t0 = time.time()
    for i in range(args.ttis):
        rx, sf_idx, mcs, st, l, grant, tb = _random_grant(rng, cell, ofdm, args.prb)
        tb_hat, ok, _, n_it = ue.decode(rx[None], sf_idx, grant)
        n_ok += int(ok and (tb_hat == tb).all())
        bits += grant.tbs
        print(f"tti {i:3d}  sf {sf_idx}  mcs {mcs:2d}  prb [{st:3d},{st+l:3d})  "
              f"tbs {grant.tbs:6d}  {'OK ' if ok else 'KO '} it={n_it}  "
              f"programs a/b/c = {ue.stats['compiles_a']}/"
              f"{ue.stats['compiles_b']}/{ue.stats['compiles_c']}")
    dt = time.time() - t0
    print(f"\n{n_ok}/{ue.stats['ttis']} grants decoded, {bits/1e6:.2f} Mbit, "
          f"{dt:.1f}s wall, {ue.total_compiles} XLA programs total "
          f"(bounded by the bucket grid, not the grant count)")


if __name__ == "__main__":
    main()
