#!/usr/bin/env python
"""PDSCH BLER / throughput sweep — the `pdsch_test` + `turbodecoder_test -t`
analog: encode a fixed (PRB, MCS) config, impair at a range of SNRs, run
the full batched receive pipeline (OFDM → chest → equalize → demod →
turbo), and print BLER + goodput per point.

  python examples/bler_sweep.py --prb 6 --mcs 7 --snr 0:10:1 --batch 32
  python examples/bler_sweep.py --prb 100 --mcs 26 \\
      --snr 14:22:1 --batch 128
"""

from __future__ import annotations

import argparse
import time

import jax

import jax.numpy as jnp
import numpy as np


def main(argv=None):
    from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.modem import Mod
    from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
    from srsran_tpu.phy.phch.pdsch import DlGrant, pdsch_encode_np
    from srsran_tpu.phy.phch.ra import dl_mcs_to_mod, dl_tbs
    from srsran_tpu.pipeline import ue_dl_subframe

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--prb", type=int, default=6)
    ap.add_argument("--mcs", type=int, default=7)
    ap.add_argument("--snr", default="0:10:1", help="start:stop:step dB")
    ap.add_argument("--batch", type=int, default=32, help="subframes per point")
    ap.add_argument("--iters", type=int, default=6, help="max turbo iterations")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    lo, hi, step = (float(v) for v in args.snr.split(":"))
    snrs = np.arange(lo, hi + 1e-9, step)
    rng = np.random.default_rng(args.seed)

    cell = Cell(nof_prb=args.prb, nof_ports=1, id=301)
    tbs = dl_tbs(args.mcs, args.prb)
    grant = DlGrant(prb=tuple(range(args.prb)), mod=dl_mcs_to_mod(args.mcs),
                    tbs=tbs)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    B = args.batch

    # one clean transmit subframe per batch slot (distinct payloads)
    txs, tbs_true = [], []
    for _ in range(B):
        tb = rng.integers(0, 2, tbs).astype(np.uint8)
        grid = pdsch_encode_np(cell, 2, 1, grant, tb)
        put_crs_np(grid, cell, 2)
        txs.append(np.asarray(ofdm_tx_sf(ofdm, grid))[0])
        tbs_true.append(tb)
    tx = np.stack(txs)[:, None, :]  # (B, 1, sf_len)
    sig_pow = float(np.mean(np.abs(tx) ** 2))

    single = ue_dl_subframe(cell, 2, 1, grant, max_iterations=args.iters)
    fn = jax.jit(lambda x: jax.vmap(single)(
        x[..., 0] + 1j * x[..., 1])[1].astype(jnp.int32))

    mod_name = Mod(grant.mod).name if not isinstance(grant.mod, Mod) else grant.mod.name
    print(f"# PDSCH {args.prb} PRB MCS {args.mcs} ({mod_name}, TBS {tbs}), "
          f"{B} subframes/point, <= {args.iters} iterations")
    print(f"# {'SNR dB':>7} {'BLER':>9} {'ok':>5} {'Mbps':>9} {'ms/pt':>8}")
    for snr_db in snrs:
        amp = np.sqrt(sig_pow / (2.0 * 10 ** (snr_db / 10)))
        noise = amp * (rng.standard_normal(tx.shape)
                       + 1j * rng.standard_normal(tx.shape))
        s = (tx + noise).astype(np.complex64)
        sri = np.stack([s.real, s.imag], -1).astype(np.float32)
        t0 = time.time()
        ok = int(np.asarray(fn(sri)).sum())
        dt = time.time() - t0
        bler = 1.0 - ok / B
        print(f"  {snr_db:7.1f} {bler:9.4f} {ok:3d}/{B} "
              f"{ok * tbs / dt / 1e6:9.1f} {dt*1e3:8.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
