"""The port's ragged decodes (per-channel lengths in one call) against the
JAX package, on inputs made with numpy.

Lengths cover 0, 1, S, S + 1, T and random values, with a message length
that is not a multiple of 8.  One test runs the JAX package's soft ragged
byte decode in interpret mode; the others are held against its scans
(`viterbi_decode_ragged`, `viterbi_decode_ragged_soft`).
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
from convolutionalencdec_tpu_torch.ops import viterbi as port_viterbi

K3K2 = dict(K=3, k=2, g=(0o17, 0o06, 0o13))
B, L = 11, 45   # T - S = 45 message bits: not a multiple of 8


def _specs(name):
    if name == "K3k2":
        return ref.CodeSpec(**K3K2), port.CodeSpec(**K3K2)
    return getattr(ref, name), port.PRESETS[name]


def _lengths(spec, T, seed):
    rng = np.random.default_rng(seed)
    edge = [0, 1, spec.S, spec.S + 1, T]
    return np.concatenate([edge, rng.integers(0, T + 1, B - len(edge))]
                          ).astype(np.int32)


def _segments(spec, T, seed):
    return np.random.default_rng(seed).integers(
        0, 1 << spec.n, (B, T), dtype=np.uint8)


def _pack(bits):
    padded = np.zeros((bits.shape[0], 8 * ((bits.shape[1] + 7) // 8)),
                      np.uint8)
    padded[:, :bits.shape[1]] = bits
    return np.packbits(padded, axis=1)


@pytest.mark.parametrize("name", ["NASA_K7", "REF_K7", "NASA_K7_R13",
                                  "K9_561_753", "K5_23_35", "TOY_K3", "K3k2"])
def test_ragged_hard_entries_match_scan(name):
    ref_spec, spec = _specs(name)
    T = L // spec.k + spec.S
    seg, lens = _segments(spec, T, 1), _lengths(spec, T, 2)
    want = np.asarray(ref_viterbi.viterbi_decode_ragged(ref_spec, seg, lens))
    assert want.shape == (B, (T - spec.S) * spec.k)
    got = kernels.viterbi_decode_batch_ragged(spec, torch.from_numpy(seg),
                                              torch.from_numpy(lens))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    got = kernels.viterbi_decode_batch_bytes_ragged(
        spec, torch.from_numpy(seg), torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), _pack(want))
    np.testing.assert_array_equal(
        port_viterbi.viterbi_decode_ragged(spec, torch.from_numpy(seg),
                                           torch.from_numpy(lens)).numpy(),
        want)


@pytest.mark.parametrize("qmax", [7, 127])
@pytest.mark.parametrize("name", ["NASA_K7", "NASA_K7_R13", "K9_561_753",
                                  "K5_23_35"])
def test_ragged_soft_bytes_match_scan(name, qmax):
    """Soft ragged bytes against the JAX scan on the LLRs as the JAX
    package conditions them on its soft route (int8 cast, -127 floor, the
    clip where its 8-bit kernel runs)."""
    ref_spec, spec = _specs(name)
    T = L + spec.S
    rng = np.random.default_rng(qmax)
    q = rng.integers(-128, 128, (B, T, spec.n)).astype(np.int8)
    lens = _lengths(spec, T, 3)
    qc = np.maximum(q.astype(np.int32), -127)
    if ref_swar.swar8_soft_supported(ref_spec, qmax):
        qc = np.clip(qc, -qmax, qmax)
    want = np.asarray(ref_metrics.viterbi_decode_ragged_soft(ref_spec, qc,
                                                             lens))
    got = kernels.viterbi_decode_batch_soft_bytes_ragged(
        spec, torch.from_numpy(q), torch.from_numpy(lens), qmax=qmax)
    np.testing.assert_array_equal(got.numpy(), _pack(want))
    np.testing.assert_array_equal(
        port.viterbi_decode_ragged_soft(spec, torch.from_numpy(qc),
                                        torch.from_numpy(lens)).numpy(), want)


def test_soft_bytes_ragged_matches_interpreted_kernel():
    """One interpret-mode call of the JAX soft ragged byte decode (its 8-bit
    kernel and the ragged traceback K2r), LLRs up to +-20 so that the clip
    shows."""
    ref_spec, spec = _specs("NASA_K7")
    T = L + spec.S
    q = np.random.default_rng(4).integers(-20, 21, (B, T, 2)).astype(np.int8)
    lens = _lengths(spec, T, 5)
    want = np.asarray(ref_kernels.viterbi_decode_batch_soft_bytes_ragged(
        ref_spec, q, lens, interpret=True))
    got = kernels.viterbi_decode_batch_soft_bytes_ragged(
        spec, torch.from_numpy(q), torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("out", ["bytes", "bits"])
@pytest.mark.parametrize("name", ["NASA_K7", "LTE_TBCC_K7", "K9_561_753"])
def test_traceback_batch_ragged_plain_route(name, out):
    """traceback_batch_ragged on a CPU tensor against the JAX ragged
    epilogue, at full and cut row widths."""
    ref_spec, spec = _specs(name)
    T = L + spec.S
    seg, lens = _segments(spec, T, 6), _lengths(spec, T, 7)
    want_d, _ = jax.vmap(
        lambda s: ref_viterbi.viterbi_forward_butterfly(ref_spec, s))(seg)
    want = np.asarray(ref_viterbi.ragged_epilogue(ref_spec, want_d,
                                                  jax.numpy.asarray(lens), T))
    words, _ = acs.acs_forward_batch(spec, torch.from_numpy(seg))
    for width in (T - spec.S, 37, 8, 0):
        got = acs.traceback_batch_ragged(spec, words, torch.from_numpy(lens),
                                         width, out)
        exp = want[:, :width]
        np.testing.assert_array_equal(got.numpy(),
                                      _pack(exp) if out == "bytes" else exp)


def test_ragged_epilogue_and_num_pad_match_reference():
    ref_spec, spec = _specs("NASA_K7")
    T = L + spec.S
    seg, lens = _segments(spec, T, 8), _lengths(spec, T, 9)
    dec, _ = port_viterbi.viterbi_forward_butterfly(spec,
                                                    torch.from_numpy(seg))
    for num_pad in (0, 3, -1):
        want = np.asarray(jax.vmap(lambda d: ref_viterbi.traceback_terminated(
            ref_spec, d, num_pad))(dec.numpy()))
        got = port_viterbi.traceback_terminated(spec, dec, num_pad)
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(ref_viterbi.ragged_epilogue(
        ref_spec, dec.numpy(), jax.numpy.asarray(lens), T))
    got = port_viterbi.ragged_epilogue(spec, dec, torch.from_numpy(lens), T)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ragged_rejects_bad_arguments():
    spec = port.NASA_K7
    seg = torch.zeros((3, 20), dtype=torch.uint8)
    lens = torch.tensor([20, 7, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="termination"):
        kernels.viterbi_decode_batch_ragged(spec, seg[:, :5], lens)
    with pytest.raises(ValueError, match="shape"):
        kernels.viterbi_decode_batch_bytes_ragged(spec, seg, lens[:2])
    with pytest.raises(ValueError):
        kernels.viterbi_decode_batch_soft_bytes_ragged(
            spec, torch.zeros((3, 20, 3), dtype=torch.int8), lens)
    words, _ = acs.acs_forward_batch(spec, seg)
    with pytest.raises(ValueError, match="message_bits_max"):
        acs.traceback_batch_ragged(spec, words, lens, 20 - spec.S + 1)
    with pytest.raises(ValueError, match="lengths"):
        acs.traceback_batch_ragged(spec, words, lens.to(torch.int64), 8)
    with pytest.raises(ValueError):
        acs.traceback_batch_ragged(spec, words, lens, 8, out="words")


def test_ragged_cpu_launches_nothing_and_meta_raises():
    for key in acs.LAUNCHES:
        acs.LAUNCHES[key] = 0
    spec = port.NASA_K7
    seg = torch.zeros((3, 20), dtype=torch.uint8)
    lens = torch.tensor([20, 7, 0], dtype=torch.int32)
    out = kernels.viterbi_decode_batch_bytes_ragged(spec, seg, lens)
    assert out.shape == (3, 2) and not out.any()
    assert not any(acs.LAUNCHES.values())
    meta = seg.to("meta")
    with pytest.raises(ValueError, match="not supported"):
        kernels.viterbi_decode_batch_ragged(spec, meta, lens.to("meta"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kernels.viterbi_decode_batch_ragged(port.TOY_K3, meta,
                                            lens.to("meta"))
