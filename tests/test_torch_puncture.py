"""The port's puncturing and its one-call punctured decoders against the JAX
package, on inputs made with numpy.  The decoders are held to the JAX
pipeline of a manual depuncture plus the soft scan."""

import numpy as np
import pytest
import torch

import jax

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu.ops import metrics as ref_metrics
from convolutionalencdec_tpu.ops import puncture as ref_puncture

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch import kernels
from convolutionalencdec_tpu_torch.ops import puncture

PATTERNS = {"r23": puncture.PUNCTURE_2_3, "r34": puncture.PUNCTURE_3_4,
            "r56": puncture.PUNCTURE_5_6}


def test_patterns_equal_reference():
    assert puncture.PUNCTURE_2_3 == ref_puncture.PUNCTURE_2_3
    assert puncture.PUNCTURE_3_4 == ref_puncture.PUNCTURE_3_4
    assert puncture.PUNCTURE_5_6 == ref_puncture.PUNCTURE_5_6


@pytest.mark.parametrize("T", [1, 2, 7, 30, 31])
@pytest.mark.parametrize("pid", list(PATTERNS))
def test_mask_puncture_depuncture_match_reference(pid, T):
    pattern = PATTERNS[pid]
    mask = puncture.puncture_mask(pattern, T)
    assert isinstance(mask, np.ndarray) and mask.dtype == bool
    np.testing.assert_array_equal(mask,
                                  ref_puncture.puncture_mask(pattern, T))
    rng = np.random.default_rng(T)
    bits = rng.integers(0, 2, (3, T * 2), dtype=np.uint8)
    kept = puncture.puncture_bits(torch.from_numpy(bits), pattern, T)
    want = np.asarray(ref_puncture.puncture_bits(bits, pattern, T))
    np.testing.assert_array_equal(kept.numpy(), want)
    llrs = rng.integers(-7, 8, want.shape).astype(np.int8)
    full = puncture.depuncture_llrs(torch.from_numpy(llrs), pattern, T)
    assert full.dtype == torch.int8
    np.testing.assert_array_equal(
        full.numpy(), np.asarray(ref_puncture.depuncture_llrs(llrs, pattern,
                                                              T)))


@pytest.mark.parametrize("pid", list(PATTERNS))
def test_punctured_rate_and_row_check(pid):
    pattern = PATTERNS[pid]
    assert puncture.punctured_rate(port.NASA_K7, pattern) == \
        ref_puncture.punctured_rate(ref.NASA_K7, pattern)
    puncture.check_pattern_rows(port.NASA_K7, pattern)
    with pytest.raises(ValueError, match="rows"):
        puncture.check_pattern_rows(port.LTE_TBCC_K7, pattern)
    with pytest.raises(ValueError, match="rows"):
        puncture.punctured_rate(port.LTE_TBCC_K7, pattern)
    with pytest.raises(ValueError, match="rows"):
        kernels.viterbi_decode_batch_punctured(
            port.NASA_K7_R13, torch.zeros((1, 10), dtype=torch.uint8),
            pattern, 10)
    with pytest.raises(ValueError, match="rows"):
        kernels.viterbi_decode_batch_punctured_soft(
            port.NASA_K7_R13, torch.zeros((1, 10), dtype=torch.int8),
            pattern, 10)
    with pytest.raises(ValueError):
        puncture.puncture_mask((1, 0, 1), 5)


@pytest.mark.parametrize("pid", ["r23", "r34"])
def test_punctured_entries_match_reference_pipeline(pid):
    """Both one-call punctured decoders against the JAX pipeline: manual
    depuncture plus the soft scan, per channel."""
    pattern = PATTERNS[pid]
    ref_spec, spec = ref.NASA_K7, port.NASA_K7
    rng = np.random.default_rng(6)
    B, L = 3, 240
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = port.encode_bits(spec, torch.from_numpy(msgs))[0]
    T = coded.shape[-1]
    cbits = port.segments_to_bits(coded, spec.n)
    tx = puncture.puncture_bits(cbits, pattern, T).numpy().copy()
    for pos in range(7, tx.shape[-1], 53):
        tx[:, pos] ^= 1
    rx_llr = 1 - 2 * tx.astype(np.int32)
    full = np.asarray(ref_puncture.depuncture_llrs(rx_llr, pattern, T))
    want = np.asarray(jax.vmap(lambda x: ref_metrics.viterbi_decode_soft(
        ref_spec, x))(full.reshape(B, T, spec.n)))
    got = kernels.viterbi_decode_batch_punctured(spec, torch.from_numpy(tx),
                                                 pattern, T)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), msgs)   # the flips corrected
    got = kernels.viterbi_decode_batch_punctured(spec, torch.from_numpy(tx),
                                                 pattern, T, 200)
    np.testing.assert_array_equal(got.numpy(), want[:, :200])

    # Soft LLRs with -128 entries and magnitudes past qmax: the JAX
    # pipeline floors at -127, depunctures, and (NASA_K7 at qmax 7 rides
    # its 8-bit kernel) clips to +-7.
    q = rng.integers(-128, 128, tx.shape).astype(np.int8)
    q[:, ::9] = -128
    q = np.where(tx == 1, -np.abs(q.astype(np.int32)),
                 np.abs(q.astype(np.int32)))
    q = np.clip(q, -128, 127).astype(np.int8)
    full = np.asarray(ref_puncture.depuncture_llrs(
        np.maximum(q.astype(np.int32), -127), pattern, T))
    want = np.asarray(jax.vmap(lambda x: ref_metrics.viterbi_decode_soft(
        ref_spec, x))(np.clip(full, -7, 7).reshape(B, T, spec.n)))
    got = kernels.viterbi_decode_batch_punctured_soft(
        spec, torch.from_numpy(q), pattern, T)
    np.testing.assert_array_equal(got.numpy(), want)
