"""The hybrid family (zamba2-2.7b) under impl pallas against the JAX
reference; the kernels at its full-width shapes.

* Served at ``--reduced`` under paper-iv, impl pallas (every 2-D dense
  linear, the shared block's reshaped attention projections included, on
  kernel 1 and kernel 5: their plain versions on the CPU): greedy tokens
  equal the reference's, the prefill and first decode logits within
  rtol=0.05, atol=0.1, the serving artifact bitwise. The reference runs
  with XLA's excess precision off in a process of its own (weights as in
  ``test_torch_mamba2.py``).
* ``cuda``-marked: kernels 1 and 5 (the tensor-core body and the decode
  form) at zamba2's full-width shapes bitwise their plain versions (skip
  without a card).
"""
import numpy as np
import pytest
import torch

from test_torch_mamba2 import BATCH, NEW, reference_fixtures

torch.set_num_threads(1)

ARCH = "zamba2-2.7b"


_reference_process, both = reference_fixtures(
    "test_torch_mamba2", f"serve_both({ARCH!r}, ('pallas',), artifact=False)")


def test_greedy_tokens_equal_the_reference(both):
    got = both["pallas"]
    assert np.array(got["ref"]).shape == (BATCH, NEW)
    assert got["port"] == got["ref"]
    assert all(len(set(r)) > 1 for r in got["ref"]), got["ref"]


def test_logits_and_artifact_equal_the_reference(both):
    got = both["pallas"]
    assert got["outside"] == [0, 0, 0], got["max_abs"]
    assert got["leaves"][0] == got["leaves"][1] and got["artifact_equal"]
    assert got["n_packed"] == 0


# ---------------------------------------------------------------------------
# kernels 1 and 5 at zamba2's full-width shapes (card only)
# ---------------------------------------------------------------------------

# (K, N) of zamba2-2.7b's 2-D dense linears under impl pallas: w_z / w_x,
# w_b / w_c, w_dt, w_out; the shared block's wq / wk / wv / wo (reshaped to
# 2-D) and mlp.wi / mlp.wo
SHAPES = ((2560, 5120), (2560, 64), (2560, 80), (5120, 2560), (2560, 2560),
          (2560, 10240), (10240, 2560))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k, n", SHAPES)
def test_dense_pallas_kernels_bitwise_at_zamba2_shapes(cuda, k, n):
    """Kernel 1 on x and on w.T, then kernel 5's tensor-core body (300
    rows), and kernel 1 then kernel 5's decode form (8 rows; the weight's
    Algorithm 1 in its loader): each bitwise its plain versions on the same
    card tensors."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.bfp_matmul import (bfp_decode_matmul_plain,
                                                bfp_matmul_quantized_plain)
    from repro_torch.kernels.hif4_quant import absorbed_activation

    g = torch.Generator(device=cuda).manual_seed(k * 7 + n)
    w = (torch.randn(k, n, generator=g, device=cuda) * 0.02).to(torch.bfloat16)
    x = torch.randn(300, k, generator=g, device=cuda).to(torch.bfloat16)
    ai, asc = absorbed_activation(x)
    wi, wsc = absorbed_activation(w.T.contiguous())
    want = bfp_matmul_quantized_plain(ai, asc, wi.T, wsc.T)
    got = ops.matmul(x, w)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    x8 = x[:8].contiguous()
    ai, asc = absorbed_activation(x8)
    want = bfp_decode_matmul_plain(ai, asc, w)
    got = ops.matmul(x8, w)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
