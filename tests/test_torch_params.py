"""The port's numpy-only CodeSpec and trellis tables equal the JAX
package's, and the port imports no jax."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu.ops import trellis as ref_trellis

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch.ops import trellis as port_trellis

PRESET_NAMES = ["NASA_K7", "REF_K7", "TOY_K3", "K5_23_35", "K9_561_753",
                "NASA_K7_R13", "LTE_TBCC_K7"]

PROPERTIES = ["K", "g", "k", "starting_state", "traceback_len", "n", "S",
              "rate", "num_states", "num_edges_per_state", "delay_width",
              "g_reversed", "has_poly_symmetry", "metric_dtype"]

TABLES = ["edge_coded_bits", "next_state_table", "prev_state_table",
          "butterfly_coded_bits"]


def _random_spec_args(seed):
    """(K, k, g) of a valid random spec, k in {1, 2}."""
    rng = np.random.default_rng(seed)
    while True:
        k = int(rng.integers(1, 3))
        K = int(rng.integers(2, {1: 9, 2: 5}[k] + 1))
        n = int(rng.integers(max(2, k), 5))
        g = tuple(int(rng.integers(1, 1 << (k * K))) for _ in range(n))
        try:
            ref.CodeSpec(K=K, k=k, g=g)
        except ValueError:
            continue
        return K, k, g


RANDOM_ARGS = [_random_spec_args(s) for s in (11, 12, 13, 14)]
PAIRS = ([(getattr(ref, n), port.PRESETS[n]) for n in PRESET_NAMES]
         + [(ref.CodeSpec(K=K, k=k, g=g), port.CodeSpec(K=K, k=k, g=g))
            for K, k, g in RANDOM_ARGS])
PAIR_IDS = PRESET_NAMES + [f"random_K{K}k{k}n{len(g)}"
                           for K, k, g in RANDOM_ARGS]


@pytest.mark.parametrize("ref_spec,port_spec", PAIRS, ids=PAIR_IDS)
def test_codespec_matches_reference(ref_spec, port_spec):
    for name in PROPERTIES:
        assert getattr(port_spec, name) == getattr(ref_spec, name), name
    for bits in (0, 12, 2 * port_spec.k):
        for terminate in (True, False):
            assert (port_spec.coded_segments_for(bits, terminate)
                    == ref_spec.coded_segments_for(bits, terminate))


@pytest.mark.parametrize("ref_spec,port_spec", PAIRS, ids=PAIR_IDS)
def test_trellis_tables_match_reference(ref_spec, port_spec):
    for name in TABLES:
        if name == "butterfly_coded_bits" and not ref_spec.has_poly_symmetry:
            with pytest.raises(ValueError):
                getattr(ref_trellis, name)(ref_spec)
            with pytest.raises(ValueError):
                getattr(port_trellis, name)(port_spec)
            continue
        want = getattr(ref_trellis, name)(ref_spec)
        got = getattr(port_trellis, name)(port_spec)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("name", PRESET_NAMES)
def test_from_reference_round_trips(name):
    ref_spec, port_spec = getattr(ref, name), port.PRESETS[name]
    carried = port.from_reference(ref_spec)
    assert carried == port_spec and hash(carried) == hash(port_spec)
    assert port.from_reference(carried) == port_spec
    back = ref.CodeSpec(K=carried.K, g=carried.g, k=carried.k,
                        starting_state=carried.starting_state,
                        traceback_len=carried.traceback_len)
    assert back == ref_spec


@pytest.mark.parametrize("kwargs", [
    dict(K=1, g=(1,)), dict(K=3, k=0, g=(5,)), dict(K=3, g=()),
    dict(K=3, g=(0b1111,)), dict(K=7, g=(0o133, 0o171), starting_state=1),
    dict(K=11, k=3, g=(1,)),
], ids=["K1", "k0", "no_g", "g_wide", "start1", "too_wide"])
def test_validation_matches_reference(kwargs):
    with pytest.raises(ValueError):
        ref.CodeSpec(**kwargs)
    with pytest.raises(ValueError):
        port.CodeSpec(**kwargs)


def test_port_imports_no_jax():
    """In a fresh interpreter (this one imported jax for the tests)."""
    root = Path(__file__).resolve().parent.parent
    package = root / "convolutionalencdec_tpu_torch"
    modules = sorted(
        ".".join(("convolutionalencdec_tpu_torch",)
                 + p.relative_to(package).with_suffix("").parts)
        for p in package.rglob("*.py") if p.name != "__init__.py")
    assert {"convolutionalencdec_tpu_torch.kernels.generic",
            "convolutionalencdec_tpu_torch.kernels.maxlogmap",
            "convolutionalencdec_tpu_torch.kernels.turbo",
            "convolutionalencdec_tpu_torch.kernels.tailbiting",
            "convolutionalencdec_tpu_torch.ops.lte",
            "convolutionalencdec_tpu_torch.ops.crc",
            "convolutionalencdec_tpu_torch.kernels.single_pass",
            "convolutionalencdec_tpu_torch.harness.bounds",
            "convolutionalencdec_tpu_torch.harness.ber",
            "convolutionalencdec_tpu_torch.harness.curve",
            "convolutionalencdec_tpu_torch.harness.speed",
            "convolutionalencdec_tpu_torch.utils.telemetry"} <= set(modules)
    code = (f"import sys, convolutionalencdec_tpu_torch, {', '.join(modules)}; "
            "print(sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
            "'convolutionalencdec_tpu.', 'triton'))"
            " or m == 'convolutionalencdec_tpu'))")
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=root, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout
