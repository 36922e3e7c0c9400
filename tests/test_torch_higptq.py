"""HiGPTQ of the port (``repro_torch.core.higptq``) against the reference's
(``repro.core.higptq``) on the same numpy inputs, at the shapes of
``tests/test_higptq.py``.

* Against the reference: at least 99% of the output values equal (the
  Hessian's f32 matmul and the per-row updates sum in another order than
  XLA's, so a compensated row may land one quantum away now and then), the
  layer-output error within 1% relative, the first group's grid bitwise
  (Algorithm 1 on the same weights), and with orthonormal activations
  (H = 1.01 I exactly: no row compensates another) the whole output
  bitwise: both packages then compute ``round(w / quantum) * quantum`` on
  the same grid, rounding half to even.
* The port alone: the Hessian is positive definite, HiGPTQ beats the direct
  cast by 10% on correlated activations, its output sits on a HiF4 grid,
  and on white activations it stays within 5% of the direct cast.

The card's HiGPTQ and calibration are held against the CPU's in
``tests/test_torch_cuda.py`` (a file without JAX) and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import higptq as ref_higptq
from repro_torch.core import hif4
from repro_torch.core.higptq import (
    _group_grid,
    hessian_from_activations,
    higptq_quantize,
    layer_output_error,
    quantize_stacked,
)

torch.set_num_threads(1)

# (K, N, samples, correlated) of tests/test_higptq.py
SHAPES = {"beats_direct": (256, 64, 512, True), "on_grid": (128, 32, 256, True),
          "white": (128, 16, 2048, False)}


def _correlated_acts(rng, n, k):
    """Activations with correlated features (a low-rank mix plus noise)."""
    base = rng.standard_normal((n, k // 4)).astype(np.float32)
    mix = rng.standard_normal((k // 4, k)).astype(np.float32) * 0.5
    return base @ mix + 0.1 * rng.standard_normal((n, k)).astype(np.float32)


def _inputs(name, seed=0):
    k, n, s, correlated = SHAPES[name]
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    x = (_correlated_acts(rng, s, k) if correlated
         else rng.standard_normal((s, k)).astype(np.float32))
    return w, x


def _direct_cast(w: torch.Tensor) -> torch.Tensor:
    k, n = w.shape
    g = hif4.quantize_groups(w.T.reshape(n, k // 64, 64).to(torch.float32))
    return hif4.dequantize_groups(g).reshape(n, k).T.to(w.dtype)


@pytest.fixture(scope="module")
def both():
    """{shape name: (w, x, port output, reference output)}."""
    out = {}
    for name in SHAPES:
        w, x = _inputs(name)
        port = higptq_quantize(torch.from_numpy(w), torch.from_numpy(x))
        ref = np.asarray(ref_higptq.higptq_quantize(jnp.asarray(w), jnp.asarray(x)))
        out[name] = (w, x, port.numpy(), ref)
    return out


@pytest.mark.parametrize("name", list(SHAPES))
def test_values_equal_the_reference(both, name):
    w, x, port, ref = both[name]
    same = float(np.mean(port == ref))
    assert same >= 0.99, (name, same)


@pytest.mark.parametrize("name", list(SHAPES))
def test_layer_output_error_equals_the_reference(both, name):
    w, x, port, ref = both[name]
    e_port = layer_output_error(torch.from_numpy(w), torch.from_numpy(port),
                                torch.from_numpy(x))
    e_ref = ref_higptq.layer_output_error(jnp.asarray(w), jnp.asarray(ref),
                                          jnp.asarray(x))
    assert abs(e_port - e_ref) <= 0.01 * e_ref, (e_port, e_ref)


@pytest.mark.parametrize("name", list(SHAPES))
def test_first_group_grid_is_bitwise(name):
    w, _ = _inputs(name)
    port = _group_grid(torch.from_numpy(w[:64])).numpy()
    ref = np.asarray(ref_higptq._group_grid(jnp.asarray(w[:64])))
    np.testing.assert_array_equal(port.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("n", [16, 64])
def test_orthonormal_activations_are_bitwise(n):
    k = 256
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    x = 16.0 * np.eye(k, dtype=np.float32)          # X^T X / n = I exactly
    h = hessian_from_activations(torch.from_numpy(x))
    assert torch.equal(h, 1.01 * torch.eye(k))
    port = higptq_quantize(torch.from_numpy(w), torch.from_numpy(x)).numpy()
    ref = np.asarray(ref_higptq.higptq_quantize(jnp.asarray(w), jnp.asarray(x)))
    np.testing.assert_array_equal(port.view(np.uint32), ref.view(np.uint32))


def test_hessian_is_positive_definite():
    x = _correlated_acts(np.random.default_rng(5), 64, 128)
    h = hessian_from_activations(torch.from_numpy(x))
    assert float(torch.linalg.eigvalsh(h).min()) > 0
    ref = np.asarray(ref_higptq.hessian_from_activations(jnp.asarray(x)))
    np.testing.assert_allclose(h.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_beats_direct_cast(both):
    w, x, port, _ = both["beats_direct"]
    w, x = torch.from_numpy(w), torch.from_numpy(x)
    e_gptq = layer_output_error(w, torch.from_numpy(port), x)
    e_direct = layer_output_error(w, _direct_cast(w), x)
    assert e_gptq < 0.9 * e_direct, (e_gptq, e_direct)


def test_output_on_hif4_grid(both):
    """Re-quantizing HiGPTQ's output changes (almost) nothing."""
    _, _, port, _ = both["on_grid"]
    wq = torch.from_numpy(port)
    assert bool(torch.isfinite(wq).all())
    rel = float(torch.linalg.norm(_direct_cast(wq) - wq)
                / torch.clamp_min(torch.linalg.norm(wq), 1e-9))
    assert rel < 0.06, rel


def test_white_activations_stay_near_direct_cast(both):
    w, x, port, _ = both["white"]
    w, x = torch.from_numpy(w), torch.from_numpy(x)
    e_gptq = layer_output_error(w, torch.from_numpy(port), x)
    e_direct = layer_output_error(w, _direct_cast(w), x)
    assert e_gptq < e_direct * 1.05, (e_gptq, e_direct)


def test_quantize_stacked_is_per_layer_higptq():
    """Each layer with its own rows, trailing dims flattened and restored,
    as the reference's."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((2, 128, 4, 8)) * 0.05).astype(np.float32)
    xs = [_correlated_acts(rng, 96, 128) for _ in range(2)]
    port = quantize_stacked(torch.from_numpy(w),
                            [torch.from_numpy(x) for x in xs], n_samples=64)
    assert port.shape == (2, 128, 4, 8)
    for i in range(2):
        one = higptq_quantize(torch.from_numpy(w[i].reshape(128, -1)),
                              torch.from_numpy(xs[i][:64]))
        assert torch.equal(port[i].reshape(128, -1), one)
    ref = np.asarray(ref_higptq.quantize_stacked(jnp.asarray(w), xs,
                                                 n_samples=64))
    assert float(np.mean(port.numpy() == ref)) >= 0.99
