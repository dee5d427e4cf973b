"""The port's soft-decision path against the JAX package, on inputs made with
numpy: quantizer, branch metrics, the soft butterfly scan, the soft kernel
wrapper's plain route, the route rule and the soft entry points.

On the CPU each wrapper takes its plain version; the CUDA kernel itself is
held to that plain version on the card by chip_smoke.py.  Two tests run the
JAX package's soft Pallas kernels in interpret mode (one call each, slow on
a CPU): one on the route of its 8-bit kernel (the clip to +-qmax shows) and
one on the route of its 16-bit kernel (the -128 floor shows, no clip).
Everything else is held against the JAX scans.
"""

import numpy as np
import pytest
import torch

import jax

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu import kernels as ref_kernels
from convolutionalencdec_tpu.kernels import acs_swar as ref_swar
from convolutionalencdec_tpu.ops import metrics as ref_metrics
from convolutionalencdec_tpu.ops import viterbi as ref_viterbi

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch import kernels
from convolutionalencdec_tpu_torch.kernels import acs
from convolutionalencdec_tpu_torch.ops import metrics

SCAN_SPECS = ["NASA_K7", "NASA_K7_R13", "LTE_TBCC_K7", "K9_561_753"]
DRAWS = ["+-qmax", "int8", "+-1", "erasures"]
K3K2 = dict(K=3, k=2, g=(0o17, 0o06, 0o13))
# NS = 32768: past the butterfly kernels' 16384 states.
K16 = port.CodeSpec(K=16, g=(0o104723, 0o153545))


def _specs(name):
    if name == "K3k2":
        return ref.CodeSpec(**K3K2), port.CodeSpec(**K3K2)
    return getattr(ref, name), port.PRESETS[name]


def _draw(kind, shape, seed, qmax=7):
    """int32 LLRs: +-qmax, full int8 (with -128), +-1, or +-qmax with 20%
    zeros (erasures)."""
    rng = np.random.default_rng(seed)
    if kind == "int8":
        q = rng.integers(-128, 128, shape)
        q.flat[::17] = -128
    elif kind == "+-1":
        q = rng.choice(np.array([-1, 1]), shape)
    else:
        q = rng.integers(-qmax, qmax + 1, shape)
        if kind == "erasures":
            q = np.where(rng.random(shape) < 0.2, 0, q)
    return q.astype(np.int32)


def _jax_conditioned(ref_spec, q, qmax):
    """The JAX package's conditioning on its soft route, from its own rule:
    an int8 cast, the -127 floor, and the clip to +-qmax only where its
    8-bit kernel runs."""
    q = np.maximum(q.astype(np.int8).astype(np.int32), -127)
    if ref_swar.swar8_soft_supported(ref_spec, qmax):
        q = np.clip(q, -qmax, qmax)
    return q


@pytest.mark.parametrize("qmax", [1, 7, 31])
def test_quantize_llrs_explicit_scale_is_exact(qmax):
    llr = np.random.default_rng(qmax).normal(0, 9, (6, 300)).astype(np.float32)
    llr[0, :6] = [0.5, 1.5, 2.5, -0.5, -1.5, 0.0]   # ties round to even
    for scale in (1.0, 0.37, 2.9):
        got = metrics.quantize_llrs(torch.from_numpy(llr), qmax, scale)
        want = np.asarray(ref_metrics.quantize_llrs(llr, qmax, scale))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert metrics.quantize_llrs(torch.tensor([0.5, 1.5, -2.5]), 7,
                                 1.0).tolist() == [0, 2, -2]


def test_quantize_llrs_auto_scale():
    """The automatic scale 3 sqrt(mean(llr^2)) / qmax is a float32 mean,
    and torch and XLA sum in different orders: the scale can differ in its
    last bit, which moves an LLR lying within that bit of a rounding
    boundary by one step.  So at most 1 in 10^4 entries may differ, by at
    most 1."""
    llr = np.random.default_rng(5).normal(1.2, 6, (64, 2048)).astype(
        np.float32)
    got = metrics.quantize_llrs(torch.from_numpy(llr)).numpy()
    want = np.asarray(ref_metrics.quantize_llrs(llr))
    diff = np.abs(got.astype(np.int64) - want)
    assert diff.max() <= 1
    assert (diff != 0).mean() <= 1e-4
    assert got.min() >= -metrics.DEFAULT_QMAX and got.max() <= 7
    zeros = metrics.quantize_llrs(torch.zeros((3, 4)))
    assert not zeros.any()


@pytest.mark.parametrize("name", ["NASA_K7", "NASA_K7_R13", "TOY_K3", "K3k2"])
def test_soft_step_metrics_are_exact(name):
    ref_spec, spec = _specs(name)
    q = _draw("int8", (2, 9, spec.n), 3)
    want = np.asarray(ref_metrics.soft_step_metrics(ref_spec, q))
    got = metrics.soft_step_metrics(spec, torch.from_numpy(q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("draw", DRAWS)
@pytest.mark.parametrize("name", SCAN_SPECS)
def test_forward_butterfly_soft_matches_reference(name, draw):
    """Decisions and final metrics of the soft butterfly scan, as it stands
    (no floor, no clip), against the JAX scan; then from carried initial
    metrics against the JAX generic ACS over soft branch metrics."""
    ref_spec, spec = _specs(name)
    B, T = 3, 40
    q = _draw(draw, (B, T, spec.n), 7)
    want_d, want_m = jax.vmap(
        lambda x: ref_metrics.viterbi_forward_butterfly_soft(ref_spec, x))(q)
    got_d, got_m = metrics.viterbi_forward_butterfly_soft(
        spec, torch.from_numpy(q))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))

    init = np.random.default_rng(2).integers(
        0, 60, (B, spec.num_states)).astype(np.int32)
    bm = np.asarray(ref_metrics.soft_step_metrics(ref_spec, q))
    want_d, want_m = jax.vmap(lambda b, i: ref_viterbi.viterbi_forward(
        ref_spec, b, initial_metrics=i))(bm, init)
    got_d, got_m = metrics.viterbi_forward_butterfly_soft(
        spec, torch.from_numpy(q), torch.from_numpy(init))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("qclip", [1, 7, 127])
@pytest.mark.parametrize("name", ["NASA_K7", "NASA_K7_R13", "K9_561_753"])
def test_soft_kernel_wrapper_plain_route(name, qclip):
    """acs_forward_batch_soft on a CPU tensor: the words unpack to the JAX
    scan's decisions on the floored and clipped LLRs, with the default,
    carried and all-zero starts."""
    ref_spec, spec = _specs(name)
    B, T = 4, 33
    q = _draw("int8", (B, T, spec.n), qclip)
    qc = np.clip(np.maximum(q, -127), -qclip, qclip)
    q8 = torch.from_numpy(q.astype(np.int8))
    want_d, want_m = jax.vmap(
        lambda x: ref_metrics.viterbi_forward_butterfly_soft(ref_spec, x))(qc)
    words, fm = acs.acs_forward_batch_soft(spec, q8, qclip)
    assert words.dtype == torch.int32
    assert words.shape == (B, T, spec.num_states // 32)
    np.testing.assert_array_equal(acs.unpack_decisions(spec, words).numpy(),
                                  np.asarray(want_d))
    np.testing.assert_array_equal(fm.numpy(), np.asarray(want_m))
    bm = np.asarray(ref_metrics.soft_step_metrics(ref_spec, qc))
    for init in (np.array(want_m), np.zeros(want_m.shape, np.int32)):
        want_d, want_m2 = jax.vmap(lambda b, i: ref_viterbi.viterbi_forward(
            ref_spec, b, initial_metrics=i))(bm, init)
        words, fm = acs.acs_forward_batch_soft(spec, q8, qclip,
                                               torch.from_numpy(init))
        np.testing.assert_array_equal(
            acs.unpack_decisions(spec, words).numpy(), np.asarray(want_d))
        np.testing.assert_array_equal(fm.numpy(), np.asarray(want_m2))


def test_soft_kernel_wrapper_rejects_bad_arguments():
    spec = port.NASA_K7
    q = torch.zeros((2, 20, 2), dtype=torch.int8)
    with pytest.raises(ValueError):
        acs.acs_forward_batch_soft(spec, q.to(torch.int32), 7)
    with pytest.raises(ValueError):
        acs.acs_forward_batch_soft(spec, q[..., :1], 7)
    for qclip in (0, 128):
        with pytest.raises(ValueError, match="qclip"):
            acs.acs_forward_batch_soft(spec, q, qclip)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        acs.acs_forward_batch_soft(K16, torch.zeros((2, 20, 2),
                                                    dtype=torch.int8), 7)
    # T * n * 127 + init_metric_value must stay below 2^31.
    huge = torch.zeros((0, 2 ** 31 // 254, 2), dtype=torch.int8)
    with pytest.raises(ValueError, match="overflows"):
        acs.acs_forward_batch_soft(spec, huge, 7)
    with pytest.raises(ValueError, match="not supported"):
        acs.acs_forward_batch_soft(spec, q.to("meta"), 7)


@pytest.mark.parametrize("qmax", [1, 4, 7, 8, 12, 31, 127])
def test_route_rule_matches_reference(qmax):
    """The port's copy of the JAX package's route rule agrees with the
    original on every preset and two K=8 codes, and picks the clip."""
    specs = [(getattr(ref, n), port.PRESETS[n]) for n in port.PRESETS]
    specs += [(ref.CodeSpec(K=8, g=g), port.CodeSpec(K=8, g=g))
              for g in ((0o247, 0o371), (0o225, 0o331, 0o367))]
    for ref_spec, spec in specs:
        assert (kernels.swar_layout_supported(spec)
                == ref_swar.swar_layout_supported(ref_spec)), spec
        assert (kernels.swar8_soft_supported(spec, qmax)
                == ref_swar.swar8_soft_supported(ref_spec, qmax)), spec
        route = kernels.select_kernel(spec, "soft", qmax)
        if not kernels.kernel_supports(spec):
            assert route == kernels.GENERIC
        elif ref_swar.swar8_soft_supported(ref_spec, qmax):
            assert route == kernels.SOFT8
            assert kernels.soft_qclip(spec, qmax) == qmax
        else:
            assert route == kernels.SOFT
            assert kernels.soft_qclip(spec, qmax) == 127


def test_soft_entry_k3_route_matches_interpreted_kernel():
    """NASA_K7 at qmax 7 rides the JAX 8-bit soft kernel, whose pack clips
    LLRs to +-qmax: an input of 20 decodes as 7.  One interpret-mode call."""
    ref_spec, spec = _specs("NASA_K7")
    assert kernels.select_kernel(spec, "soft", 7) == kernels.SOFT8
    B, L = 4, 60
    q = np.random.default_rng(8).integers(-20, 21, (B, L + spec.S, spec.n))
    q = q.astype(np.int8)
    want = np.asarray(ref_kernels.viterbi_decode_batch_soft_bytes(
        ref_spec, q, interpret=True, qmax=7))
    got = kernels.viterbi_decode_batch_soft_bytes(spec, torch.from_numpy(q),
                                                  qmax=7)
    np.testing.assert_array_equal(got.numpy(), want)
    bits = kernels.viterbi_decode_batch_soft(spec, torch.from_numpy(q), qmax=7)
    np.testing.assert_array_equal(bits.numpy(),
                                  np.unpackbits(want, axis=1)[:, :L])
    # The clip shows: decoding the unclipped values differs.
    unclipped = np.asarray(jax.vmap(lambda x: ref_metrics.viterbi_decode_soft(
        ref_spec, x))(q.astype(np.int32)))
    clipped = np.asarray(jax.vmap(lambda x: ref_metrics.viterbi_decode_soft(
        ref_spec, x))(np.clip(q.astype(np.int32), -7, 7)))
    assert (unclipped != clipped).any()
    np.testing.assert_array_equal(bits.numpy(), clipped)


def test_soft_entry_k4_route_matches_interpreted_kernel():
    """NASA_K7_R13 at qmax 7 rides the JAX 16-bit soft kernel: -128 is
    floored to -127 and nothing is clipped.  One interpret-mode call."""
    ref_spec, spec = _specs("NASA_K7_R13")
    assert kernels.select_kernel(spec, "soft", 7) == kernels.SOFT
    B, L = 4, 52
    q = _draw("int8", (B, L + spec.S, spec.n), 9).astype(np.int8)
    assert (q == -128).any()
    want = np.asarray(ref_kernels.viterbi_decode_batch_soft(
        ref_spec, q, interpret=True, qmax=7))
    got = kernels.viterbi_decode_batch_soft(spec, torch.from_numpy(q), qmax=7)
    np.testing.assert_array_equal(got.numpy(), want)
    floored = np.maximum(q.astype(np.int32), -127)
    np.testing.assert_array_equal(want, np.asarray(jax.vmap(
        lambda x: ref_metrics.viterbi_decode_soft(ref_spec, x))(floored)))


@pytest.mark.parametrize("qmax", [1, 7, 31])
@pytest.mark.parametrize("name", ["NASA_K7", "REF_K7", "NASA_K7_R13",
                                  "K9_561_753", "K5_23_35"])
def test_soft_entries_match_scan(name, qmax):
    """Bits and bytes of the soft entry points against the JAX scan on the
    inputs as the JAX package conditions them on its soft route."""
    ref_spec, spec = _specs(name)
    B, L = 3, 45
    q = _draw("int8", (B, L + spec.S, spec.n), qmax)
    want = np.asarray(jax.vmap(lambda x: ref_metrics.viterbi_decode_soft(
        ref_spec, x))(_jax_conditioned(ref_spec, q, qmax)))
    q8 = torch.from_numpy(q.astype(np.int8))
    got = kernels.viterbi_decode_batch_soft(spec, q8, qmax=qmax)
    np.testing.assert_array_equal(got.numpy(), want)
    for mb in (L, 40, 13):
        got = kernels.viterbi_decode_batch_soft_bytes(spec, q8, mb, qmax=qmax)
        padded = np.zeros((B, 8 * ((mb + 7) // 8)), np.uint8)
        padded[:, :mb] = want[:, :mb]
        np.testing.assert_array_equal(got.numpy(),
                                      np.packbits(padded, axis=1))


@pytest.mark.parametrize("name", ["TOY_K3", "K3k2"])
def test_viterbi_decode_soft_generic_matches_reference(name):
    """Codes without the butterfly decode through the generic ACS over
    soft branch metrics; the batch entry points refuse them, as the JAX
    package's do."""
    ref_spec, spec = _specs(name)
    q = _draw("+-qmax", (2, 24 + spec.S, spec.n), 4)
    want = np.asarray(jax.vmap(lambda x: ref_metrics.viterbi_decode_soft(
        ref_spec, x))(q))
    got = metrics.viterbi_decode_soft(spec, torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        kernels.viterbi_decode_batch_soft(spec, torch.from_numpy(q))


def test_hard_bits_as_qllrs_decode_like_hard_bits():
    ref_spec, spec = _specs("NASA_K7")
    rng = np.random.default_rng(12)
    seg = rng.integers(0, 4, (3, 50), dtype=np.uint8)
    bits = port.segments_to_bits(torch.from_numpy(seg), 2)
    q = metrics.hard_bits_to_qllrs(bits)
    assert q.dtype == torch.int32
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(ref_metrics.hard_bits_to_qllrs(bits.numpy())))
    soft = kernels.viterbi_decode_batch_soft(spec, q.reshape(3, 50, 2))
    hard = kernels.viterbi_decode_batch(spec, torch.from_numpy(seg))
    assert torch.equal(soft, hard)


def test_soft_cpu_tensors_launch_no_kernel_and_meta_raises():
    for key in acs.LAUNCHES:
        acs.LAUNCHES[key] = 0
    q = torch.from_numpy(_draw("+-qmax", (2, 30, 2), 1).astype(np.int8))
    kernels.viterbi_decode_batch_soft_bytes(port.NASA_K7, q)
    acs.acs_forward_batch_soft(port.NASA_K7, q, 7)
    assert not any(acs.LAUNCHES.values())
    meta = torch.empty((2, 30, 2), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        kernels.viterbi_decode_batch_soft(port.NASA_K7, meta)
    with pytest.raises(ValueError, match="not supported"):
        kernels.viterbi_decode_batch_soft(port.K5_23_35, meta)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kernels.viterbi_decode_batch_soft(K16, meta)
