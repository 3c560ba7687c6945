import numpy as np
import pytest

from srsran_tpu.phy.fec import cbsegm
from srsran_tpu.phy.fec.turbo import map_decoder, turbo_decode, turbo_encode_np


def test_cb_sizes_table():
    assert cbsegm.NOF_CB_SIZES == 188
    assert cbsegm.CB_SIZES[0] == 40
    assert cbsegm.CB_SIZES[-1] == 6144
    assert 512 in cbsegm.CB_SIZES and 528 in cbsegm.CB_SIZES


def test_cbsegm_single():
    s = cbsegm.cbsegm(1000)
    assert s.C == 1 and s.C_plus == 1 and s.C_minus == 0
    assert s.K_plus >= 1024  # 1000 + 24 CRC
    assert s.F == s.K_plus - 1024


def test_cbsegm_multi():
    s = cbsegm.cbsegm(20000)
    B = 20000 + 24
    assert s.C == int(np.ceil(B / 6120))
    Bp = B + s.C * 24
    assert s.C_plus * s.K_plus + s.C_minus * s.K_minus - s.F == Bp
    assert s.K_plus in cbsegm.CB_SIZES
    if s.C_minus:
        assert s.K_minus in cbsegm.CB_SIZES


def test_qpp_is_permutation():
    for k in (40, 512, 1056, 6144):
        per = cbsegm.qpp_interleaver_np(k)
        assert sorted(per.tolist()) == list(range(k))


def test_encoder_output_shape_and_termination():
    rng = np.random.default_rng(0)
    for k in (40, 64, 528):
        bits = rng.integers(0, 2, k).astype(np.uint8)
        d = turbo_encode_np(bits)
        assert d.shape == (3, k + 4)
        np.testing.assert_array_equal(d[0, :k], bits)


def llrs_from_d(d, ebn0_db, rng, rate=1 / 3):
    """Real BPSK over AWGN → LLRs (positive ⇒ bit 1).

    N0 = 2*sigma^2 for real signaling, so sigma^2 = 1/(2*R*10^(EbN0/10)).
    """
    sigma2 = 1.0 / (2.0 * rate * 10 ** (ebn0_db / 10))
    tx = 1.0 - 2.0 * d.astype(np.float32)  # bit0→+1, bit1→-1
    y = tx + rng.standard_normal(d.shape).astype(np.float32) * np.sqrt(sigma2)
    return (-2.0 * y / sigma2).astype(np.float32)


@pytest.mark.parametrize("k", [40, 96, 512, 1056])
def test_turbo_decode_noiseless(k):
    rng = np.random.default_rng(k)
    b = 4
    bits = rng.integers(0, 2, (b, k)).astype(np.uint8)
    d = np.stack([turbo_encode_np(row) for row in bits])  # (b,3,k+4)
    llr = llrs_from_d(d, 10.0, rng) * 0 + (1.0 - 2.0 * d) * -8.0
    dec, post, n_it = turbo_decode(llr, k, max_iterations=2)
    np.testing.assert_array_equal(np.asarray(dec), bits)


@pytest.mark.parametrize("k,ebn0", [(40, 2.5), (512, 1.8), (2048, 1.5), (6144, 1.2)])
def test_turbo_decode_awgn(k, ebn0):
    """Error-free above the per-K waterfall (mirrors the reference FEC tests'
    fixed-Eb/N0 BER assertions, fec/test/CMakeLists.txt:44-70)."""
    rng = np.random.default_rng(k + 1)
    b = 4
    bits = rng.integers(0, 2, (b, k)).astype(np.uint8)
    d = np.stack([turbo_encode_np(row) for row in bits])
    llr = llrs_from_d(d, ebn0, rng)
    dec, post, n_it = turbo_decode(llr, k, max_iterations=8)
    ber = np.mean(np.asarray(dec) != bits)
    assert ber == 0.0, f"K={k}: ber={ber}"


def test_turbo_crc_early_stop():
    from srsran_tpu.phy.crc import crc_matrix_np
    from srsran_tpu.phy.common import LTE_CRC24B
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    k = 512
    b = 4
    msgs = rng.integers(0, 2, (b, k - 24)).astype(np.uint8)
    from srsran_tpu.phy.crc import crc_attach_np

    cbs = np.stack([crc_attach_np(m, LTE_CRC24B) for m in msgs])
    d = np.stack([turbo_encode_np(row) for row in cbs])
    llr = llrs_from_d(d, 1.8, rng)
    # full-K CRC check matrix: remainder of the whole K bits must be 0
    table = crc_matrix_np(LTE_CRC24B, k).astype(np.float32)
    dec, post, n_it = turbo_decode(llr, k, max_iterations=8, crc_table=jnp.asarray(table))
    np.testing.assert_array_equal(np.asarray(dec), cbs)
    assert int(n_it) < 8  # early-stopped


def test_map_decoder_single_pass_highsnr():
    rng = np.random.default_rng(9)
    k = 64
    bits = rng.integers(0, 2, (2, k)).astype(np.uint8)
    d = np.stack([turbo_encode_np(row) for row in bits])
    llr = (1.0 - 2.0 * d).astype(np.float32) * -4.0
    from srsran_tpu.phy.fec.turbo import dstream_tails
    import jax.numpy as jnp

    lx1, lz1, lx2, lz2 = dstream_tails(jnp.asarray(llr[:, :, k:]))
    post = map_decoder(
        jnp.asarray(llr[:, 0, :k]), jnp.asarray(llr[:, 1, :k]), lx1, lz1, k
    )
    np.testing.assert_array_equal(np.asarray(post > 0).astype(np.uint8), bits)


@pytest.mark.parametrize("k", [512, 2048, 5824, 6144])
def test_map_decoder_pallas_parity(k):
    """The Pallas MAP kernel (interpret mode on CPU) matches the XLA scan
    bit-exactly: the same float32 adds and maxes in the same order."""
    import jax.numpy as jnp

    B = 2
    rng = np.random.default_rng(k)
    args = [jnp.asarray(3 * rng.standard_normal((B, n)).astype(np.float32))
            for n in (k, k, 3, 3)]
    r_scan = np.asarray(map_decoder(*args, k, backend="scan"))
    r_pal = np.asarray(map_decoder(*args, k, backend="pallas_interpret"))
    np.testing.assert_array_equal(r_pal, r_scan)


@pytest.mark.parametrize("layout", [(2, 91), (3, 33)])
def test_map_decoder_pallas_odd_window(monkeypatch, layout):
    """Odd window lengths (no LTE size takes one today) run the kernel's
    middle-position step; still bit-exact with the scan."""
    import jax.numpy as jnp

    from srsran_tpu.phy.fec import turbo

    monkeypatch.setattr(turbo, "_window_layout", lambda k: layout)
    k = layout[0] * layout[1]
    rng = np.random.default_rng(k)
    args = [jnp.asarray(3 * rng.standard_normal((2, n)).astype(np.float32))
            for n in (k, k, 3, 3)]
    r_scan = np.asarray(map_decoder(*args, k, backend="scan"))
    r_pal = np.asarray(map_decoder(*args, k, backend="pallas_interpret"))
    np.testing.assert_array_equal(r_pal, r_scan)


def test_map_windows_lane_padding():
    """Lane counts that are not a multiple of the program's block are
    padded and cropped: 3 codeblocks x 22 windows = 66 lanes."""
    import jax.numpy as jnp

    from srsran_tpu.phy.fec.turbo_kernel import lanes_per_program

    assert lanes_per_program(1) == 32
    assert lanes_per_program(66) == 128
    assert lanes_per_program(1 << 16) == 128
    k = 2112  # 22 windows of 96
    rng = np.random.default_rng(5)
    args = [jnp.asarray(3 * rng.standard_normal((3, n)).astype(np.float32))
            for n in (k, k, 3, 3)]
    r_scan = np.asarray(map_decoder(*args, k, backend="scan"))
    r_pal = np.asarray(map_decoder(*args, k, backend="pallas_interpret"))
    np.testing.assert_array_equal(r_pal, r_scan)


def test_auto_backend_cpu():
    """On the CPU (and with bf16 metrics anywhere) "auto" takes the scan."""
    import jax.numpy as jnp

    from srsran_tpu.phy.fec.turbo import auto_backend

    assert auto_backend() == "scan"
    assert auto_backend(jnp.bfloat16) == "scan"


def test_auto_backend_gpu_process(monkeypatch):
    """A GPU process takes the kernel for every LTE codeblock size — no
    window layout falls back — unless a `jax.default_device(cpu)` scope
    pins the computation to the host."""
    import jax
    import jax.numpy as jnp

    from srsran_tpu.phy.fec import cbsegm, turbo
    from srsran_tpu.phy.fec.turbo import auto_backend

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert auto_backend() == "pallas"
    assert auto_backend(jnp.bfloat16) == "scan"
    with jax.default_device(jax.devices("cpu")[0]):
        assert auto_backend() == "scan"
    with jax.default_device("cpu"):
        assert auto_backend() == "scan"
    # every layout the decoder produces is one the kernel runs
    lws = {turbo._window_layout(k)[1] for k in cbsegm.CB_SIZES}
    assert min(lws) >= 8 and max(lws) <= 160


def test_auto_backend_routes_map_decoder(monkeypatch):
    """`map_decoder(backend="auto")` dispatches on `auto_backend`."""
    import jax.numpy as jnp

    from srsran_tpu.phy.fec import turbo

    calls = []
    monkeypatch.setattr(turbo, "auto_backend",
                        lambda dtype=None: calls.append(1) or "pallas_interpret")
    k = 512
    rng = np.random.default_rng(1)
    args = [jnp.asarray(rng.standard_normal((1, n)).astype(np.float32))
            for n in (k, k, 3, 3)]
    r = np.asarray(map_decoder(*args, k))
    np.testing.assert_array_equal(
        r, np.asarray(map_decoder(*args, k, backend="scan")))
    assert calls == [1]


@pytest.mark.gpu
def test_map_kernel_matches_scan_on_card(gpu):
    """On the card, K=6144 x 256 codeblocks at 1.6 dB: the compiled kernel
    and the XLA scan decode identical bits, and posteriors agree within
    2e-3 (float32 max-log; the scan's fused adds may round in another
    order)."""
    import jax.numpy as jnp

    k, b = 6144, 256
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (b, k)).astype(np.uint8)
    d = np.stack([turbo_encode_np(row) for row in bits])
    llr = jnp.asarray(llrs_from_d(d, 1.6, rng))
    dec_k, post_k, _ = turbo_decode(llr, k, 5, backend="pallas")
    dec_s, post_s, _ = turbo_decode(llr, k, 5, backend="scan")
    np.testing.assert_array_equal(np.asarray(dec_k), np.asarray(dec_s))
    np.testing.assert_allclose(np.asarray(post_k), np.asarray(post_s),
                               atol=2e-3, rtol=0)


@pytest.mark.parametrize("backend", ["scan4", "scan_fused"])
@pytest.mark.parametrize("k", [40, 2048, 6144])
def test_map_decoder_backend_equivalence(backend, k):
    """The radix-4 and fused-scan MAP forms compute exactly the radix-2
    max-log recursion (associativity of max over path segments)."""
    from srsran_tpu.phy.fec.turbo import map_decoder

    import jax.numpy as jnp

    B = 3
    rng = np.random.default_rng(11)
    args = [jnp.asarray(rng.standard_normal((B, n)).astype(np.float32)) for n in (k, k, 3, 3)]
    ref = np.asarray(map_decoder(*args, k, backend="scan"))
    alt = np.asarray(map_decoder(*args, k, backend=backend))
    np.testing.assert_allclose(ref, alt, atol=2e-4)
