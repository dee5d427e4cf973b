"""The port's kernel wrappers and batch entry points on the CPU.

A CPU tensor takes each wrapper's plain version; the CUDA kernels
themselves run only on the card (chip_smoke.py compares them with these
plain versions there).  Here the plain route is held against the JAX
package: its Pallas kernels in interpret mode (two calls, they are slow on
a CPU) and its scan decoders for the other presets.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu import kernels as ref_kernels
from convolutionalencdec_tpu.ops import viterbi as ref_viterbi

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch import kernels
from convolutionalencdec_tpu_torch.kernels import _build, acs, generic, stream

KERNEL_PRESETS = ["NASA_K7", "REF_K7", "NASA_K7_R13", "LTE_TBCC_K7",
                  "K9_561_753"]
K3K2 = dict(K=3, k=2, g=(0o17, 0o06, 0o13))
# The widest code the kernels take (NS = 16384, the rate-1/4 code of the
# Galileo experiment) and one past them (NS = 32768).
K15 = port.CodeSpec(K=15, g=(0o46321, 0o51271, 0o63667, 0o70535))
K16 = port.CodeSpec(K=16, g=(0o104723, 0o153545))


def _specs(name):
    if name == "K3k2":
        return ref.CodeSpec(**K3K2), port.CodeSpec(**K3K2)
    return getattr(ref, name), port.PRESETS[name]


def _noisy(spec, B, L, p, seed):
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = port.encode_bits(spec, torch.from_numpy(msgs))[0].numpy().copy()
    flip = rng.random(coded.shape) < p
    coded ^= (flip * rng.integers(1, 1 << spec.n, coded.shape)).astype(np.uint8)
    return msgs, coded


@pytest.mark.parametrize("name", ["NASA_K7", "NASA_K7_R13"])
def test_batch_decode_matches_interpreted_pallas_kernels(name):
    """One interpret-mode call of the JAX kernels K1/K2 per spec."""
    ref_spec, spec = _specs(name)
    B, L = 8, 100
    _, coded = _noisy(spec, B, L, 0.05, 17)
    want = np.asarray(ref_kernels.viterbi_decode_batch_bytes(
        ref_spec, coded, interpret=True))
    seg = torch.from_numpy(coded)
    got = kernels.viterbi_decode_batch_bytes(spec, seg)
    np.testing.assert_array_equal(got.numpy(), want)
    bits = kernels.viterbi_decode_batch(spec, seg)
    np.testing.assert_array_equal(bits.numpy(),
                                  np.unpackbits(want, axis=1)[:, :L])


@pytest.mark.parametrize("p", [0.03, 0.25])
@pytest.mark.parametrize("name", ["REF_K7", "LTE_TBCC_K7", "K9_561_753",
                                  "TOY_K3", "K5_23_35", "K3k2"])
def test_batch_decode_matches_scan(name, p):
    ref_spec, spec = _specs(name)
    B, L = 5, 58
    _, coded = _noisy(spec, B, L, p, 23)
    seg = torch.from_numpy(coded)
    want_bits = np.asarray(
        jax.vmap(lambda c: ref.viterbi_decode(ref_spec, c))(coded))
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch(spec, seg).numpy(), want_bits)
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch(spec, seg, 40).numpy(), want_bits[:, :40])
    for mb in (L, 48):
        want = np.asarray(jax.vmap(
            lambda c: ref.viterbi_decode_bytes(ref_spec, c, mb))(coded))
        np.testing.assert_array_equal(
            kernels.viterbi_decode_batch_bytes(spec, seg, mb).numpy(), want)


@pytest.mark.parametrize("p", [0.03, 0.25])
@pytest.mark.parametrize("name", KERNEL_PRESETS)
def test_kernel_wrappers_plain_route_match_reference(name, p):
    """acs_forward_batch / traceback_batch on CPU tensors: decisions, final
    metrics, bits and bytes equal to the JAX scans."""
    ref_spec, spec = _specs(name)
    B, L = 3, 61
    _, coded = _noisy(spec, B, L, p, 29)
    seg = torch.from_numpy(coded)
    T = coded.shape[1]
    want_d, want_m = jax.vmap(
        lambda c: ref_viterbi.viterbi_forward_butterfly(ref_spec, c))(coded)
    words, fm = acs.acs_forward_batch(spec, seg)
    assert words.dtype == torch.int32 and words.shape == (B, T,
                                                          spec.num_states // 32)
    np.testing.assert_array_equal(acs.unpack_decisions(spec, words).numpy(),
                                  np.asarray(want_d))
    np.testing.assert_array_equal(fm.numpy(), np.asarray(want_m))
    assert torch.equal(acs.pack_decisions(spec, torch.from_numpy(
        np.array(want_d))), words)

    want_bits = np.asarray(jax.vmap(
        lambda d: ref_viterbi.traceback_terminated(ref_spec, d))(want_d))
    for mb in (L, 56, 13):
        bits = acs.traceback_batch(spec, words, T, mb, out="bits")
        np.testing.assert_array_equal(bits.numpy(), want_bits[:, :mb])
        data = acs.traceback_batch(spec, words, T, mb, out="bytes")
        padded = np.zeros((B, 8 * ((mb + 7) // 8)), np.uint8)
        padded[:, :mb] = want_bits[:, :mb]
        np.testing.assert_array_equal(data.numpy(), np.packbits(padded, axis=1))

    # The carried-metrics seam.
    start = np.random.default_rng(2).integers(
        0, 20, (B, spec.num_states)).astype(np.int32)
    want_d, want_m = jax.vmap(lambda c, i: ref_viterbi.viterbi_forward_butterfly(
        ref_spec, c, i))(coded, start)
    words, fm = acs.acs_forward_batch(spec, seg, torch.from_numpy(start))
    np.testing.assert_array_equal(acs.unpack_decisions(spec, words).numpy(),
                                  np.asarray(want_d))
    np.testing.assert_array_equal(fm.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("name", KERNEL_PRESETS)
def test_decision_word_layout(name):
    """State s = 2b + p sits at bit i % 32 of word i // 32,
    i = p * NS/2 + b; bit 31 makes the int32 word negative."""
    spec = port.PRESETS[name]
    NS = spec.num_states
    one_hot = torch.eye(NS, dtype=torch.uint8).reshape(1, NS, NS)
    words = acs.pack_decisions(spec, one_hot)[0]          # [NS steps, W]
    for s in range(NS):
        i = (s >> 1) + (s & 1) * NS // 2
        expect = torch.zeros(NS // 32, dtype=torch.int64)
        expect[i // 32] = 1 << (i % 32)
        got = words[s].to(torch.int64) & 0xFFFFFFFF
        assert torch.equal(got, expect), s
    assert torch.equal(acs.unpack_decisions(spec, words[None]), one_hot)


def test_select_kernel_routes():
    expected = {"NASA_K7": kernels.BUTTERFLY, "REF_K7": kernels.BUTTERFLY,
                "NASA_K7_R13": kernels.BUTTERFLY,
                "LTE_TBCC_K7": kernels.BUTTERFLY,
                "K9_561_753": kernels.BUTTERFLY, "TOY_K3": kernels.GENERIC_K,
                "K5_23_35": kernels.BUTTERFLY}
    assert set(expected) == set(port.PRESETS)
    for name, route in expected.items():
        assert kernels.select_kernel(port.PRESETS[name]) == route, name
    assert kernels.select_kernel(port.CodeSpec(**K3K2)) == kernels.GENERIC_K
    # K=8 (128 states) rides the butterfly kernels; an asymmetric K=7 code
    # the generic-k ones.
    assert kernels.select_kernel(
        port.CodeSpec(K=8, g=(0o247, 0o371))) == kernels.BUTTERFLY
    assert kernels.select_kernel(
        port.CodeSpec(K=7, g=(0o134, 0o171))) == kernels.GENERIC_K
    # Soft: NASA_K7 at the default qmax 7 is on the route of the JAX 8-bit
    # soft kernel (LLRs clipped to +-qmax); at qmax 31, and NASA_K7_R13 at
    # any qmax, on the any-int8 route; codes off the kernels stay GENERIC.
    assert kernels.select_kernel(port.NASA_K7, mode="soft") == kernels.SOFT8
    assert kernels.select_kernel(port.NASA_K7, "soft", 31) == kernels.SOFT
    assert kernels.select_kernel(port.NASA_K7_R13, "soft", 7) == kernels.SOFT
    assert kernels.select_kernel(port.K5_23_35, "soft") == kernels.SOFT
    # Butterfly codes up to NS = 16384 ride the kernels (K=15 included);
    # NS = 32768 (K=16) is past them, hard and soft.
    assert kernels.select_kernel(K15) == kernels.BUTTERFLY
    assert kernels.select_kernel(K15, "soft") == kernels.SOFT
    assert kernels.select_kernel(K16) == kernels.GENERIC
    assert kernels.select_kernel(K16, "soft") == kernels.GENERIC
    # Given T, every preset keeps its route (each is on a JAX SWAR
    # kernel's); a rate-1/5 K=8 code takes the single pass while its
    # decisions fit 32 KiB per channel (T_pad <= 2016), as the JAX
    # package's viterbi_decode_batch(_soft) does.
    for name, route in expected.items():
        assert kernels.select_kernel(port.PRESETS[name], T=2054) == route
    assert kernels.select_kernel(port.NASA_K7, "soft", T=2054) == \
        kernels.SOFT8
    assert kernels.select_kernel(port.NASA_K7_R13, "soft", T=50) == \
        kernels.SOFT
    k8_n5 = port.CodeSpec(K=8, g=(0o247, 0o371, 0o275, 0o313, 0o357))
    assert kernels.select_kernel(k8_n5) == kernels.BUTTERFLY
    for mode in ("hard", "soft"):
        assert kernels.select_kernel(k8_n5, mode, T=2016) == \
            kernels.SINGLE_PASS
    assert kernels.select_kernel(k8_n5, T=2017) == kernels.BUTTERFLY
    assert kernels.select_kernel(k8_n5, "soft", T=2017) == kernels.SOFT
    with pytest.raises(ValueError, match="mode"):
        kernels.select_kernel(port.NASA_K7, mode="list")


def test_cpu_tensors_launch_no_kernel():
    for counts in (acs.LAUNCHES, generic.LAUNCHES):
        for key in counts:
            counts[key] = 0
    _, coded = _noisy(port.NASA_K7, 2, 40, 0.03, 31)
    seg = torch.from_numpy(coded)
    kernels.viterbi_decode_batch_bytes(port.NASA_K7, seg)
    kernels.viterbi_decode_batch(port.NASA_K7, seg)
    words, _ = acs.acs_forward_batch(port.NASA_K7, seg)
    acs.traceback_batch(port.NASA_K7, words, seg.shape[1], 40)
    acs.traceback_batch_masked(port.NASA_K7, words,
                               torch.zeros(2, dtype=torch.int32), 40, 40)
    acs.traceback_batch_multi(port.NASA_K7, words,
                              torch.zeros((2, 3), dtype=torch.int32), 40, 8,
                              32)
    state = stream.stream_state_init(port.NASA_K7, 2, "cpu")
    stream.stream_decode_batch(port.NASA_K7, seg, state)
    k2 = port.CodeSpec(K=4, k=2, g=(0o133, 0o171, 0o266))
    for spec in (port.TOY_K3, k2):
        _, coded = _noisy(spec, 2, 40, 0.03, 31)
        seg = torch.from_numpy(coded)
        kernels.viterbi_decode_batch_bytes(spec, seg)
        kernels.viterbi_decode_batch_generic(spec, seg)
        planes, _ = generic.acs_forward_batch_generic(spec, seg)
        generic.traceback_batch_generic(spec, planes, seg.shape[1], 40)
    kernels.viterbi_decode_batch_k2(k2, seg)
    planes, _ = generic.acs_forward_batch_k2(k2, seg)
    generic.traceback_batch_k2(k2, planes, seg.shape[1], 40, "bits")
    # The small and wide butterfly codes' wrappers and entries.
    for spec, L in ((port.K5_23_35, 40), (K15, 4)):
        _, coded = _noisy(spec, 2, L, 0.03, 31)
        seg = torch.from_numpy(coded)
        kernels.viterbi_decode_batch_bytes(spec, seg)
        kernels.viterbi_decode_batch_soft(
            spec, torch.ones(seg.shape + (spec.n,), dtype=torch.int8))
        words, _ = acs.acs_forward_batch(spec, seg)
        acs.traceback_batch_masked(spec, words,
                                   torch.zeros(2, dtype=torch.int32), 4, 4)
    assert set(acs.LAUNCHES) == {"acs_k1_forward", "traceback_k1",
                                 "acs_soft_k1_forward", "traceback_k1_ragged",
                                 "stream_k1_decode", "traceback_k1_masked",
                                 "traceback_k1_multi", "acs_small_forward",
                                 "acs_soft_small_forward", "acs_wide_forward",
                                 "acs_soft_wide_forward", "traceback_wide",
                                 "traceback_wide_ragged",
                                 "traceback_wide_masked",
                                 "traceback_wide_multi"}
    assert set(generic.LAUNCHES) == {"acs_generic_forward",
                                     "traceback_generic",
                                     "acs_generic_k2_forward",
                                     "traceback_generic_k2"}
    assert not any(acs.LAUNCHES.values())
    assert not any(generic.LAUNCHES.values())


def test_no_fallback_off_the_cpu():
    """A tensor off the CPU goes to a kernel or raises; it is never decoded
    by the plain version or moved to the CPU."""
    meta = torch.empty((2, 40), dtype=torch.uint8, device="meta")
    # Generic-k codes reach their kernel wrappers' device check.
    with pytest.raises(ValueError, match="not supported"):
        kernels.viterbi_decode_batch(port.TOY_K3, meta)
    with pytest.raises(ValueError, match="not supported"):
        kernels.viterbi_decode_batch_bytes(port.CodeSpec(**K3K2), meta)
    with pytest.raises(ValueError, match="not supported"):
        kernels.viterbi_decode_batch_bytes(port.NASA_K7, meta)
    # Small and wide butterfly codes reach their kernels' device check; a
    # code past the kernels (NS = 32768) raises.
    for spec in (port.K5_23_35, K15):
        with pytest.raises(ValueError, match="not supported"):
            kernels.viterbi_decode_batch(spec, meta)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2"):
        kernels.viterbi_decode_batch(K16, meta)
    with pytest.raises(NotImplementedError):
        acs.acs_forward_batch(port.TOY_K3,
                              torch.zeros((2, 40), dtype=torch.uint8))


def test_wrappers_reject_bad_arguments():
    spec = port.NASA_K7
    seg = torch.zeros((2, 40), dtype=torch.uint8)
    words, _ = acs.acs_forward_batch(spec, seg)
    with pytest.raises(ValueError):
        acs.acs_forward_batch(spec, seg.to(torch.int32))
    with pytest.raises(ValueError):
        acs.traceback_batch(spec, words, 40, 40 - spec.S + 1)
    with pytest.raises(ValueError):
        acs.traceback_batch(spec, words, 41, 8)
    with pytest.raises(ValueError):
        acs.traceback_batch(spec, words, 40, 8, out="words")
    with pytest.raises(ValueError):
        acs.traceback_batch(port.K9_561_753, words, 40, 8)
    with pytest.raises(ValueError):
        kernels.viterbi_decode_batch(spec, seg, message_bits=40)


def test_missing_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp_extension
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_kernel_modules_import_without_cuda_toolkit():
    """Importing and using the CPU route builds nothing and imports no
    triton, with no nvcc on PATH and no CUDA_HOME."""
    root = Path(__file__).resolve().parent.parent
    code = (
        "import sys, torch\n"
        "from convolutionalencdec_tpu_torch import kernels, NASA_K7\n"
        "from convolutionalencdec_tpu_torch.kernels import _build\n"
        "seg = torch.zeros((2, 30), dtype=torch.uint8)\n"
        "out = kernels.viterbi_decode_batch_bytes(NASA_K7, seg)\n"
        "assert out.shape == (2, 3) and not out.any()\n"
        "q = torch.ones((2, 30, 2), dtype=torch.int8)\n"
        "out = kernels.viterbi_decode_batch_soft_bytes(NASA_K7, q)\n"
        "assert out.shape == (2, 3) and not out.any()\n"
        "out = kernels.viterbi_decode_batch_soft_bytes_ragged(\n"
        "    NASA_K7, q, torch.tensor([30, 9], dtype=torch.int32))\n"
        "assert out.shape == (2, 3) and not out.any()\n"
        "from convolutionalencdec_tpu_torch import StreamingDecoderBatch\n"
        "out = StreamingDecoderBatch(NASA_K7, 2, device='cpu').decode(\n"
        "    seg, last=True)\n"
        "assert out.shape == (2, 24) and not out.any()\n"
        "assert _build.library.cache_info().currsize == 0\n"
        "assert 'triton' not in sys.modules\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME",
                                                             "CUDA_PATH")}
    env.update(PYTHONPATH=str(root), PATH=os.path.dirname(sys.executable))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=root, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _entry_points():
    """(id, call(x, **kw)) of every public entry point that takes an array,
    with the numpy input it is given."""
    rng = np.random.default_rng(41)
    spec = port.NASA_K7
    msgs = rng.integers(0, 2, (3, 40), dtype=np.uint8)
    seg = port.encode_bits(spec, torch.from_numpy(msgs))[0].numpy()
    q = rng.integers(-9, 10, (3, 46, 2)).astype(np.int8)
    lens = np.array([46, 20, 0], np.int32)
    T, pattern = 46, port.PUNCTURE_3_4
    kept = int(port.puncture_mask(pattern, T).sum())
    rx = rng.integers(0, 2, (3, kept), dtype=np.uint8)
    llr = rng.normal(0, 4, (3, 92)).astype(np.float32)
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    return [
        ("encode_bits", msgs, lambda x, **kw: port.encode_bits(spec, x, **kw)[0]),
        ("encode_bytes", msgs[:, :5] * 7,
         lambda x, **kw: port.encode_bytes(spec, x, **kw)),
        ("bsc_segments", seg,
         lambda x, **kw: port.bsc_segments(x, 2, 0.1, gen(), **kw)),
        ("bsc", msgs, lambda x, **kw: port.bsc(x, 0.1, gen(), **kw)),
        ("awgn", llr, lambda x, **kw: port.awgn(x, 3.0, 0.5, generator=gen(),
                                                **kw)),
        ("bpsk_llr", llr, lambda x, **kw: port.bpsk_llr(x, 3.0, 0.5, **kw)),
        ("quantize_llrs", llr, lambda x, **kw: port.quantize_llrs(x, **kw)),
        ("segments_to_bits", seg,
         lambda x, **kw: port.segments_to_bits(x, 2, **kw)),
        ("viterbi_decode_batch", seg,
         lambda x, **kw: port.viterbi_decode_batch(spec, x, **kw)),
        ("viterbi_decode_batch_bytes", seg,
         lambda x, **kw: port.viterbi_decode_batch_bytes(spec, x, **kw)),
        ("viterbi_decode_batch_soft", q,
         lambda x, **kw: port.viterbi_decode_batch_soft(spec, x, **kw)),
        ("viterbi_decode_batch_soft_bytes", q,
         lambda x, **kw: port.viterbi_decode_batch_soft_bytes(spec, x, **kw)),
        ("viterbi_decode_batch_punctured", rx,
         lambda x, **kw: port.viterbi_decode_batch_punctured(
             spec, x, pattern, T, **kw)),
        ("viterbi_decode_batch_punctured_soft", rx.astype(np.int8) * 5 - 2,
         lambda x, **kw: port.viterbi_decode_batch_punctured_soft(
             spec, x, pattern, T, **kw)),
        ("viterbi_decode_batch_ragged", seg,
         lambda x, **kw: port.viterbi_decode_batch_ragged(spec, x, lens,
                                                          **kw)),
        ("viterbi_decode_batch_bytes_ragged", seg,
         lambda x, **kw: port.viterbi_decode_batch_bytes_ragged(
             spec, x, lens, **kw)),
        ("viterbi_decode_batch_soft_bytes_ragged", q,
         lambda x, **kw: port.viterbi_decode_batch_soft_bytes_ragged(
             spec, x, lens, **kw)),
    ]


ENTRY_IDS = [name for name, _, _ in _entry_points()]


@pytest.mark.parametrize("name", ENTRY_IDS)
def test_numpy_input_with_device_cpu_decodes_as_a_cpu_tensor(name):
    """A numpy input with device="cpu" gives what the same data as a CPU
    tensor gives."""
    _, x, call = _entry_points()[ENTRY_IDS.index(name)]
    got = call(x, device="cpu")
    assert got.device.type == "cpu"
    assert torch.equal(got, call(torch.from_numpy(x)))


@pytest.mark.parametrize("name", ENTRY_IDS)
def test_numpy_input_without_device_needs_cuda(name, monkeypatch):
    """With no CUDA device, a numpy input and no device raises: it is never
    decoded on the CPU silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, x, call = _entry_points()[ENTRY_IDS.index(name)]
    with pytest.raises(RuntimeError, match="CUDA"):
        call(x)
