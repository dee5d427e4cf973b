"""The port's max-log-MAP (ops/maxlogmap.py, kernels/maxlogmap.py) against
the JAX package's, exactly, on the same numpy-made LLRs.

The plain scans are held against the JAX scan on every entry; the kernel
entry on a CPU tensor (its plain route) against the JAX scan of the
floored LLRs; one interpreted call of the JAX Pallas kernel pins the
contract between the kernels: equal message-bit LLRs, equal signs on the
termination steps.
"""

import numpy as np
import pytest
import torch

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu.kernels.maxlogmap_pallas import \
    maxlogmap_llrs_batch_kernel as ref_kernel
from convolutionalencdec_tpu.ops import maxlogmap as ref_map

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch.kernels import maxlogmap as kmap
from convolutionalencdec_tpu_torch.ops import maxlogmap as port_map

K2 = dict(K=3, k=2, g=(0o17, 0o06, 0o13))
SPECS = {"TOY_K3": (ref.TOY_K3, port.TOY_K3),
         "K2_RATE23": (ref.CodeSpec(**K2), port.CodeSpec(**K2)),
         "NASA_K7": (ref.NASA_K7, port.NASA_K7),
         "K9_561_753": (ref.K9_561_753, port.K9_561_753)}


def _ref_llrs(spec, q, terminated=True):
    return np.stack([np.asarray(ref_map.maxlogmap_llrs(spec, row, terminated))
                     for row in q])


def _draw(rng, B, T, n, kind):
    if kind == "int8":          # the full int8 range, -128 included
        q = rng.integers(-128, 128, (B, T, n))
    else:                       # +-7 with 20% erasures
        q = rng.integers(-7, 8, (B, T, n))
        q = np.where(rng.random(q.shape) < 0.2, 0, q)
    return q.astype(np.int32)


@pytest.mark.parametrize("terminated", [True, False])
@pytest.mark.parametrize("kind", ["+-7", "int8"])
@pytest.mark.parametrize("name", list(SPECS))
def test_llrs_match_reference_scan(name, kind, terminated):
    ref_spec, port_spec = SPECS[name]
    rng = np.random.default_rng(len(name) + 7 * terminated)
    q = _draw(rng, 3, 29 + port_spec.S, port_spec.n, kind)
    got = port_map.maxlogmap_llrs(port_spec, torch.from_numpy(q), terminated)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  _ref_llrs(ref_spec, q, terminated))


@pytest.mark.parametrize("name", ["TOY_K3", "K2_RATE23", "NASA_K7"])
def test_all_erasures(name):
    """No evidence: LLR 0 on every message bit, in both packages."""
    ref_spec, port_spec = SPECS[name]
    T = 20 + port_spec.S
    q = np.zeros((2, T, port_spec.n), np.int32)
    got = port_map.maxlogmap_llrs(port_spec, torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, _ref_llrs(ref_spec, q))
    assert not got[:, :(T - port_spec.S) * port_spec.k].any()


@pytest.mark.parametrize("terminated", [True, False])
@pytest.mark.parametrize("name", ["K2_RATE23", "NASA_K7"])
def test_decode_and_batch_match_reference(name, terminated):
    ref_spec, port_spec = SPECS[name]
    rng = np.random.default_rng(31)
    T = 24 + port_spec.S
    q = _draw(rng, 2, T, port_spec.n, "+-7")
    got = port_map.maxlogmap_decode(port_spec, torch.from_numpy(q),
                                    terminated)
    L = (T - port_spec.S if terminated else T) * port_spec.k
    assert got.shape == (2, L) and got.dtype == torch.uint8
    want = np.stack([np.asarray(ref_map.maxlogmap_decode(ref_spec, row,
                                                         terminated))
                     for row in q])
    np.testing.assert_array_equal(got.numpy(), want)
    batch = port_map.maxlogmap_llrs_batch(port_spec, torch.from_numpy(q),
                                          terminated)
    np.testing.assert_array_equal(batch.numpy(), np.asarray(
        ref_map.maxlogmap_llrs_batch(ref_spec, q, terminated)))


@pytest.mark.parametrize("terminated", [True, False])
def test_kernel_entry_floors_minus_128_on_cpu(terminated):
    """The kernel entry on a CPU tensor is its plain version: -128 floored
    at -127 (the JAX kernel entry's floor), then the scan; the plain
    `ops.maxlogmap` keeps -128, as the JAX scan does."""
    for key in kmap.LAUNCHES:
        kmap.LAUNCHES[key] = 0
    rng = np.random.default_rng(3)
    q = rng.choice(np.array([-128, -127, 127, 126, 1, -1, 0]),
                   (2, 48, 2)).astype(np.int8)
    got = kmap.maxlogmap_llrs_batch_kernel(port.NASA_K7, torch.from_numpy(q),
                                           terminated)
    floored = np.maximum(q.astype(np.int32), -127)
    np.testing.assert_array_equal(
        got.numpy(), _ref_llrs(ref.NASA_K7, floored, terminated))
    unfloored = port_map.maxlogmap_llrs(port.NASA_K7, torch.from_numpy(q),
                                        terminated)
    np.testing.assert_array_equal(
        unfloored.numpy(),
        _ref_llrs(ref.NASA_K7, q.astype(np.int32), terminated))
    assert not torch.equal(got, unfloored)
    assert not any(kmap.LAUNCHES.values())


def test_reference_kernel_contract():
    """One interpreted call of the JAX Pallas kernel: equal message-bit
    LLRs, equal signs on the S termination steps (whose values the JAX
    kernel's 2^20 penalties change)."""
    rng = np.random.default_rng(43)
    B, L = 3, 100
    q = rng.integers(-7, 8, (B, L + 6, 2)).astype(np.int8)
    want = np.asarray(ref_kernel(ref.NASA_K7, q, interpret=True))
    got = kmap.maxlogmap_llrs_batch_kernel(port.NASA_K7,
                                           torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got[:, :L], want[:, :L])
    np.testing.assert_array_equal(np.sign(got[:, L:]), np.sign(want[:, L:]))
    assert (got[:, L:] > 0).all()


def test_kernel_entry_errors():
    q = torch.zeros((2, 48, 4), dtype=torch.int8)        # NASA_K7 has n = 2
    with pytest.raises(ValueError, match="last dim"):
        kmap.maxlogmap_llrs_batch_kernel(port.NASA_K7, q)
    for spec in (port.TOY_K3, port.CodeSpec(**K2)):
        assert not kmap.maxlogmap_supported(spec)
        with pytest.raises(ValueError, match="k=1, NS >= 64"):
            kmap.maxlogmap_llrs_batch_kernel(
                spec, torch.zeros((1, 8, spec.n), dtype=torch.int8))
    assert kmap.maxlogmap_supported(port.NASA_K7)
    with pytest.raises(ValueError, match="envelope"):
        kmap.maxlogmap_llrs_batch_kernel(
            port.NASA_K7, torch.zeros((1, 1 << 20, 2), dtype=torch.int8))


def test_numpy_input_goes_to_the_card(monkeypatch):
    """With no CUDA device a non-tensor input raises unless device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = np.ones((1, 10, 2), np.int8)
    with pytest.raises(RuntimeError, match="CUDA"):
        kmap.maxlogmap_llrs_batch_kernel(port.NASA_K7, q)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_map.maxlogmap_llrs(port.NASA_K7, q)
    out = kmap.maxlogmap_llrs_batch_kernel(port.NASA_K7, q, device="cpu")
    assert out.device.type == "cpu" and out.shape == (1, 10)
