"""BER-parity gate vs the reference's own FEC test operating points.

The reference registers turbo/Viterbi tests at fixed Eb/N0 points with
recorded expected-error tables (`lib/src/phy/fec/test/CMakeLists.txt:
44-70`, `turbodecoder_test.h:33-47`, `viterbi_test.h:36-49`) — the
tightest public statement of its decoders' operating quality.  This gate
decodes at the SAME points through the JAX chain, **including the
reference's int16 LLR quantization (scale 100, `turbodecoder_test.c:
252-253`)**, and asserts our bit-error counts stay within the reference's
bars (plus Poisson slack for the different noise realization).

It fails if the TRAIN=32
training window (reference: 40, `turbodecoder_win.h win_overlap_len`),
the LLR quantization handling, or a decoder regression silently costs dB
at the waterfall.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from srsran_tpu.phy.fec.turbo import turbo_decode, turbo_encode_np
from srsran_tpu.phy.fec.conv import convcoder_encode_np, viterbi_decode

# (frames, iterations, K, EbN0_dB, reference max bit errors)
# turbodecoder_test.h expected_errors[] — 100-frame rows
TURBO_BARS = [
    (100, 2, 504, 1.0, 1922),
    (100, 3, 504, 1.0, 1096),
    (100, 2, 504, 2.0, 47),
    (100, 3, 504, 2.0, 7),
    (40, 2, 6144, 1.5, 897 * 40 // 100),
    (40, 3, 6144, 1.5, 2 * 40 // 100),
]

# viterbi_test.h expected_errors[] (tail-biting K=7, rate 1/3);
# the SSE row set — the bars every reference implementation must meet
VITERBI_BARS = [
    (1000, 40, 0.0, 7282),
    (1000, 40, 2.0, 725),
    (1000, 40, 3.0, 176),
    (1000, 40, 4.5, 24),
    (100, 1000, 2.0, 939),
    (100, 1000, 3.0, 110),
    (100, 1000, 4.5, 5),
]


def _awgn_llr(rng, bits_enc, ebno_db, rate):
    """BPSK over AWGN at Eb/N0, exactly the reference tests' channel
    (`turbodecoder_test.c:246-253`): symbol = ±1, sigma² = 1/(2·R·Eb/N0);
    LLR sign convention here: positive ⇒ bit 1."""
    sigma2 = 1.0 / (2.0 * rate * 10 ** (ebno_db / 10.0))
    y = (2.0 * bits_enc.astype(np.float32) - 1.0) + rng.standard_normal(
        bits_enc.shape).astype(np.float32) * np.sqrt(sigma2)
    return y  # scaled/quantized by the caller


@pytest.mark.parametrize("n,iters,k,ebno,bar", TURBO_BARS)
def test_turbo_ber_parity(n, iters, k, ebno, bar):
    rng = np.random.default_rng(1)
    msgs = rng.integers(0, 2, (n, k)).astype(np.uint8)
    d = np.stack([turbo_encode_np(row) for row in msgs])  # (n, 3, k+4)
    y = _awgn_llr(rng, d, ebno, 1.0 / 3.0)
    # the reference feeds int16 LLRs at scale 100 — mirror the
    # quantization so its effect is inside the gate
    llr_q = np.clip(np.round(100.0 * y), -32767, 32767).astype(np.float32)
    bits, _post, _n_it = turbo_decode(
        jnp.asarray(llr_q), k, max_iterations=iters)
    errors = int(np.sum(np.asarray(bits) != msgs))
    # Poisson slack for a different noise seed: 1.3x + 4*sqrt(bar) + 16
    limit = int(1.3 * bar + 4.0 * np.sqrt(bar) + 16)
    assert errors <= limit, (
        f"turbo K={k} Eb/N0={ebno} it={iters}: {errors} bit errors "
        f"vs reference bar {bar} (limit {limit})")


@pytest.mark.parametrize("n,k,ebno,bar", VITERBI_BARS)
def test_viterbi_ber_parity(n, k, ebno, bar):
    rng = np.random.default_rng(1)
    msgs = rng.integers(0, 2, (n, k)).astype(np.uint8)
    enc = np.stack([convcoder_encode_np(row) for row in msgs])  # (n, 3, k)
    y = _awgn_llr(rng, enc, ebno, 1.0 / 3.0)
    bits = np.asarray(viterbi_decode(jnp.asarray(y), k))
    errors = int(np.sum(bits != msgs))
    limit = int(1.3 * bar + 4.0 * np.sqrt(bar) + 16)
    assert errors <= limit, (
        f"viterbi K={k} Eb/N0={ebno}: {errors} bit errors vs reference "
        f"bar {bar} (limit {limit})")
