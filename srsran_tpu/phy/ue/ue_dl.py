"""UE downlink subframe processing — facade over the receive chain.

Re-design of `lib/src/phy/ue/ue_dl.c` (srslte_ue_dl_decode_fft_estimate
:383, blind DCI search :450-694, PDSCH decode :741): OFDM demod + channel
estimation once per subframe, then PCFICH → PDCCH blind search → grant
derivation → PDSCH decode.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..common import Cell
from ..chest.chest_dl import chest_dl
from ..ofdm import OfdmConfig, ofdm_rx_sf
from ..phch.dci import Dci1, Dci1A, Dci2
from ..phch.pcfich import pcfich_decode, pcfich_re_indices
from ..phch.pdcch import nof_cce, pdcch_blind_search, pdcch_re_indices
from ..phch.pdsch import DlGrant, DlGrant2, pdsch_decode, pdsch_decode2
from ..phch.ra import dl_mcs_to_mod, dl_tbs, riv_decode
from .. import tdd as tdd_mod


@dataclasses.dataclass
class UeDlResult:
    cfi: int = 0
    dcis: list = dataclasses.field(default_factory=list)
    tbs: list = dataclasses.field(default_factory=list)  # (tb_bits, crc_ok)
    rsrp: float = 0.0
    snr_db: float = 0.0
    noise: float = 0.0
    pdsch_symbols: np.ndarray | None = None  # equalized REs (for scopes)
    dci_used: object = None  # the DL DCI whose PDSCH was decoded (Dci1A/Dci1/Dci2)
    dci_format: str = ""  # "1A" | "1" | "2" | "2a"
    cce_used: int = -1  # its CCE start (→ PUCCH 1a resource, pucch_proc.c:257)
    phich_ack: bool | None = None  # decoded HI when a resource was watched
    deferred: bool = False  # PDSCH queued on a windowed plane (no tbs yet)
    rank: int = 0  # recommended RI (0 = not measured; cc_worker.cc:566)
    pmi: int = 0  # recommended codebook index for the measured rank
    sb_snr: np.ndarray | None = None  # per-subband SNR (linear), N entries
    #   over the TS 36.213 Table 7.2.1-3 subband grid — feeds the
    #   frequency-selective CQI reports (cqi.c:41-118)


def ue_dl_decode_subframe(
    cell: Cell,
    samples: np.ndarray,
    sf_idx: int,
    rnti: int,
    nrx: int = 1,
    known_cfi: int | None = None,
    max_iterations: int = 5,
    tdd: "TddConfig | None" = None,
    harq_softbuffers: dict | None = None,
    phich: tuple[int, int] | None = None,
    tm: int = 2,
    dynamic=None,
    deferred=None,
) -> UeDlResult:
    """Process one subframe: samples (nrx, sf_len) → decoded TBs.

    Mirrors the cc_worker DL pipeline (srsue/src/phy/cc_worker.cc:214-307).
    ``tm`` is the configured transmission mode: it selects the blind-search
    format set (1A always; plus 1 for TM1/2, 2A for TM3, 2 for TM4 — the
    ue_dl.c:56-87 format tables) and the spatial-multiplexing decode path.
    ``dynamic``: an optional `pipeline_dynamic.DynamicUeDl` — single-
    codeword FDD PDSCH decodes then run on the bucketed device path (zero
    per-grant recompiles) instead of the host-orchestrated chain.
    ``deferred``: an optional `apps.windowed_plane.WindowedUeDlPlane` —
    FDD data grants are queued into W-TTI windows instead of being
    decoded here; the result arrives via the plane's `poll` and the
    returned UeDlResult carries ``deferred=True`` with no tbs entries
    (the sf_worker-pipeline analog, cc_worker.cc:214 with N subframes
    in flight).
    With ``tdd`` set: UL subframes are skipped, special subframes decode
    only the DwPTS region with the 0.75-PRB TBS rule (ra_dl.c:399,430-432),
    and the DCI is parsed at its TDD size.
    """
    res = UeDlResult()
    is_tdd = tdd is not None
    last_symbol = None
    if is_tdd:
        sftype = tdd_mod.sf_type(tdd, sf_idx)
        if sftype == tdd_mod.SfType.U:
            return res
        if sftype == tdd_mod.SfType.S:
            last_symbol = tdd_mod.nof_dw(tdd)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    grid = np.asarray(ofdm_rx_sf(ofdm, samples))  # (nrx, nsymb, nre)
    ch = chest_dl(grid, cell, sf_idx, nof_ports=min(cell.nof_ports, 2),
                  last_symbol=last_symbol)
    ce = np.asarray(ch["ce"])  # (nrx, nports, nsymb, nre)
    noise = float(np.mean(np.asarray(ch["noise"])))
    res.noise = noise
    res.rsrp = float(np.mean(np.asarray(ch["rsrp"])))
    res.snr_db = float(10 * np.log10(np.mean(np.asarray(ch["snr"])) + 1e-12))

    # per-subband SNR over the Table 7.2.1-3 grid (frequency-selective
    # feedback input; the reference measures per-subband from the same
    # CRS estimates)
    from ..phch.uci import cqi_hl_subband_size

    k_sb = cqi_hl_subband_size(cell.nof_prb)
    if k_sb:
        p_re = np.mean(np.abs(ce[:, : min(cell.nof_ports, 2)]) ** 2,
                       axis=(0, 1, 2))          # (nre,)
        n_sb = -(-cell.nof_prb // k_sb)
        edges = np.arange(n_sb) * k_sb * 12
        sums = np.add.reduceat(p_re, edges)
        counts = np.diff(np.append(edges, p_re.size))
        res.sb_snr = (sums / counts / max(noise, 1e-12)).astype(np.float32)

    nports_cell = min(max(cell.nof_ports, 1), 2)

    if nports_cell == 2 and grid.shape[0] >= 2:
        # RI/PMI recommendation from the CRS estimates (the cc_worker
        # measurement path feeding ri_info/pmi_info): rank 2 when the
        # channel's Gram condition number stays moderate
        from ..mimo import select_pmi

        h_meas = ce[:, :2].reshape(ce.shape[0], 2, -1)[:, :, ::8]  # subsample REs
        _best2, _cap2, cond_db = select_pmi(h_meas, 2, noise_est=max(noise, 1e-9))
        res.rank = 2 if float(cond_db) < 17.0 else 1
        best1, _cap1, _ = select_pmi(h_meas, res.rank, noise_est=max(noise, 1e-9))
        res.pmi = int(np.asarray(best1))

    def equalize(idx):
        # MRC over ALL rx antennas (the reference predecodes control
        # channels with nof_rxant combining, mimo/precoding.c — using only
        # antenna 0 costs dB exactly where the stack is most fragile)
        y = grid.reshape(grid.shape[0], -1)[:, idx]  # (nrx, n)
        if nports_cell == 1:
            h = ce[:, 0].reshape(ce.shape[0], -1)[:, idx]  # (nrx, n)
            num = np.sum(y * np.conj(h), axis=0)
            den = np.sum(np.abs(h) ** 2, axis=0) + noise
            return num / den
        # 2-port cell: control channels carry SFBC (TS 36.211 §6.7-6.9)
        from ..mimo import predecode_diversity2

        h2 = ce[:, :2].reshape(ce.shape[0], 2, -1)[:, :, idx]  # (nrx, 2, n)
        x, _ = predecode_diversity2(y, h2)
        return np.asarray(x).reshape(-1)

    # CFI
    if known_cfi is None:
        cfi_hat, _ = pcfich_decode(equalize(pcfich_re_indices(cell)), cell, sf_idx)
        cfi = int(cfi_hat)
    else:
        cfi = known_cfi
    res.cfi = cfi

    if phich is not None:
        # HI for the watched (group, seq) resource (cc_worker decode_phich)
        from ..phch.phich import phich_decode, phich_re_indices

        group, n_seq = phich
        hi, _ = phich_decode(equalize(phich_re_indices(cell, group)), cell, sf_idx, n_seq)
        res.phich_ack = bool(np.asarray(hi))

    # PDCCH blind search over the TM-dependent format set (ue_dl.c:450-694
    # searches 1A plus the mode's format over common+UE spaces; the format
    # tables are ue_dl.c:56-87).  All candidate decodes of one payload
    # length are batched through the Viterbi (pdcch_blind_search).
    n = nof_cce(cell, sf_idx, cfi)
    idx = pdcch_re_indices(cell, sf_idx, cfi)[: n * 36]
    sym_eq = equalize(idx)
    len_1a = Dci1A.nof_bits(cell.nof_prb, tdd=is_tdd)
    searches: list[tuple[str, int]] = [("1A", len_1a)]
    is_crnti = not (rnti >= 0xFFF4 or rnti <= 0x0042)
    if is_crnti and tm in (1, 2):
        l1 = Dci1.nof_bits(cell.nof_prb, tdd=is_tdd)
        if l1 != len_1a:
            searches.append(("1", l1))
    elif is_crnti and tm in (3, 4):
        fmt = "2a" if tm == 3 else "2"
        searches.append((fmt, Dci2.nof_bits(cell.nof_prb, fmt, nports_cell, tdd=is_tdd)))
    found: list[tuple[str, np.ndarray, int, int]] = []
    for fmt, dci_len in searches:
        for bits, agg, cce in pdcch_blind_search(
            sym_eq, cell, sf_idx, cfi, rnti, dci_len
        ):
            found.append((fmt, bits, agg, cce))
    # prefer the TM-specific format over the 1A fallback (same priority
    # the reference applies by searching the UE-specific format first)
    found.sort(key=lambda f: f[0] == "1A")
    res.dcis = [(bits, agg, cce) for _, bits, agg, cce in found]

    for fmt, bits, agg, cce in found:
        handled = _decode_grant(
            res, fmt, bits, cce, grid, ce, noise, cell, sf_idx, cfi, rnti,
            nports_cell, is_tdd, last_symbol, max_iterations,
            harq_softbuffers, equalize,
            dynamic=dynamic, samples=samples, deferred=deferred,
        )
        if handled:
            break  # one DL grant per subframe (dedup across agg levels)
    return res


def _decode_grant(res, fmt, bits, cce, grid, ce, noise, cell, sf_idx, cfi,
                  rnti, nports_cell, is_tdd, last_symbol, max_iterations,
                  harq_softbuffers, equalize, dynamic=None, samples=None,
                  deferred=None) -> bool:
    """Parse one found DCI and decode its PDSCH; returns True if a PDSCH
    decode was attempted (the caller stops at the first one)."""
    from ..phch.pdsch import pdsch_re_indices

    if fmt in ("2", "2a"):
        try:
            dci = Dci2.unpack(bits, cell.nof_prb, fmt=fmt,
                              nof_ports=nports_cell, tdd=is_tdd)
        except ValueError:
            return False
        prb = Dci1(rbg_bitmap=dci.rbg_bitmap).prb_list(cell.nof_prb)
        if not prb:
            return False
        l_crb = len(prb)
        # TS 36.212 Table 5.3.3.1.5-4 (2 ports, 2 codewords):
        # precoding_info 0 → codebook index 1, 1 → index 2 (format 2);
        # format 2A (TM3) is large-delay CDD — no codebook index
        if fmt == "2":
            pmi = 1 + (dci.precoding_info & 1)
            scheme = "spatialmux"
        else:
            pmi = 0
            scheme = "cdd"
        try:
            grant = DlGrant2(
                prb=prb,
                mod1=dl_mcs_to_mod(dci.mcs1), tbs1=dl_tbs(dci.mcs1, l_crb),
                mod2=dl_mcs_to_mod(dci.mcs2), tbs2=dl_tbs(dci.mcs2, l_crb),
                rv1=dci.rv1, rv2=dci.rv2, pmi=pmi, rnti=rnti,
                tx_scheme=scheme,
            )
        except (ValueError, IndexError):
            return False  # reserved MCS from a CRC-RNTI false positive
        if (deferred is not None and getattr(deferred, "mimo", False)
                and not is_tdd and last_symbol is None
                and grant.tbs1 > 0 and grant.tbs2 > 0):
            deferred.submit(samples, sf_idx, grant, dci.harq_pid,
                            (dci.ndi1, dci.ndi2), tti=-1, dci=dci, fmt=fmt,
                            cce=cce)
            res.dci_used = dci
            res.dci_format = fmt
            res.cce_used = cce
            res.deferred = True
            return True
        sbs = (None, None)
        if harq_softbuffers is not None:
            stored = harq_softbuffers.get(dci.harq_pid)
            if stored is not None and stored[0] == (dci.ndi1, dci.ndi2):
                sbs = stored[1]
        out = pdsch_decode2(grid, ce, noise, cell, sf_idx, cfi, grant,
                            max_iterations, softbuffers=sbs)
        oks = [ok for _, ok, _ in out]
        if harq_softbuffers is not None:
            if all(oks):
                harq_softbuffers.pop(dci.harq_pid, None)
            else:
                harq_softbuffers[dci.harq_pid] = (
                    (dci.ndi1, dci.ndi2), tuple(sb for _, _, sb in out))
        for tb, ok, _ in out:
            res.tbs.append((tb, ok))
        res.dci_used = dci
        res.dci_format = fmt
        res.cce_used = cce
        return True

    if fmt == "1":
        try:
            dci = Dci1.unpack(bits, cell.nof_prb, tdd=is_tdd)
        except ValueError:
            return False
        prb = dci.prb_list(cell.nof_prb)
        if not prb:
            return False
        scheme = "diversity" if nports_cell >= 2 else "port0"
        try:
            grant = DlGrant(
                prb=prb, mod=dl_mcs_to_mod(dci.mcs),
                tbs=dl_tbs(dci.mcs, len(prb), dwpts=last_symbol is not None),
                rv=dci.rv, rnti=rnti, tx_scheme=scheme,
            )
        except (ValueError, IndexError):
            return False  # reserved MCS from a CRC-RNTI false positive
        ndi, harq_pid = dci.ndi, dci.harq_pid
    else:  # "1A"
        try:
            dci = Dci1A.unpack(bits, cell.nof_prb, tdd=is_tdd)
        except ValueError:
            return False
        try:
            rb0, l_crb = riv_decode(cell.nof_prb, dci.riv)
        except ValueError:
            return False
        scheme = "diversity" if nports_cell >= 2 else "port0"
        if rnti >= 0xFFF4 or rnti <= 0x0042:  # SI/P-RNTI or RA-RNTI space
            # TS 36.213 §7.1.7.2: QPSK, mcs = i_tbs, N_PRB from TPC LSB
            from ..phch.ra import tbs_lookup
            from ..modem import Mod

            n_prb_1a = 3 if (dci.tpc & 1) else 2
            grant = DlGrant(
                prb=tuple(range(rb0, rb0 + l_crb)), mod=Mod.QPSK,
                tbs=tbs_lookup(dci.mcs, n_prb_1a), rv=dci.rv, rnti=rnti,
                tx_scheme=scheme,
            )
        else:
            try:
                grant = DlGrant(
                    prb=tuple(range(rb0, rb0 + l_crb)),
                    mod=dl_mcs_to_mod(dci.mcs),
                    tbs=dl_tbs(dci.mcs, l_crb,
                               dwpts=last_symbol is not None),
                    rv=dci.rv, rnti=rnti, tx_scheme=scheme,
                )
            except (ValueError, IndexError):
                return False  # reserved MCS (CRC-RNTI false positive)
        ndi, harq_pid = dci.ndi, dci.harq_pid

    # HARQ soft combining: the caller's per-process dict carries
    # (ndi, softbuffers) between retransmissions (softbuffer.c role);
    # a toggled NDI means a NEW transport block — stale LLRs from the
    # previous (possibly failed) TB must not be combined in
    if (deferred is not None and not getattr(deferred, "mimo", False)
            and not is_tdd and last_symbol is None
            and grant.tx_scheme in ("port0", "diversity") and grant.tbs > 0):
        deferred.submit(samples, sf_idx, grant, harq_pid, ndi, tti=-1,
                        dci=dci, fmt=fmt, cce=cce)
        res.dci_used = dci
        res.dci_format = fmt
        res.cce_used = cce
        res.deferred = True
        return True
    sb = None
    if harq_softbuffers is not None:
        stored = harq_softbuffers.get(harq_pid)
        if stored is not None and stored[0] == ndi:
            sb = stored[1]
    if (dynamic is not None and not is_tdd and last_symbol is None
            and grant.tx_scheme in ("port0", "diversity") and grant.tbs > 0
            and dynamic.cfi == cfi):
        # bucketed device data path (pipeline_dynamic): any grant, no
        # per-grant recompiles, HARQ combining in the bucket layout
        tb, ok, sb_out, _ = dynamic.decode(samples, sf_idx, grant,
                                           softbuffer=sb)
    else:
        tb, ok, sb_out = pdsch_decode(
            grid, ce, noise, cell, sf_idx, cfi, grant, max_iterations,
            softbuffers=sb, tdd=is_tdd, last_symbol=last_symbol,
        )
    if harq_softbuffers is not None:
        if ok:
            harq_softbuffers.pop(harq_pid, None)  # reset on success
        else:
            harq_softbuffers[harq_pid] = (ndi, sb_out)
    res.tbs.append((tb, ok))
    res.dci_used = dci
    res.dci_format = fmt
    res.cce_used = cce
    res.pdsch_symbols = np.asarray(
        equalize(pdsch_re_indices(cell, sf_idx, cfi, grant.prb, is_tdd, last_symbol))
    )
    return True
