"""The judge on the CPU at the port's reduced widths: the plain float32
reference holds the port's CPU path, and comes out false for the fp8
control and for each fault a serve cell can have."""
import pytest
import torch

from hifbench.harness import judge, main
from hifbench.tests.tiny import TINY_LIMIT, write_tree

SEED = 2 ** 33 + 29


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("hifbench"))


def _run(tree, cell, control=False):
    return main.run(cell, SEED, 0.0, False, device="cpu", root=tree,
                    control=control)


def _clone(node):
    if isinstance(node, dict):
        return {k: _clone(v) for k, v in node.items()}
    return node.clone() if isinstance(node, torch.Tensor) else node


@pytest.mark.parametrize("cell", ["tiny-dense.chat", "tiny-ssm.chat"])
def test_reference_holds_the_program_and_fails_the_control(tree, cell):
    res = _run(tree, cell, control=True)
    gap = res["checks"]["widest_logit_gap"]
    assert res["correct"] and gap["value"] <= gap["limit"] == TINY_LIMIT
    assert res["detail"]["served_tokens_judged"] == 4 * 6      # one call of 4
    control = res["detail"]["control_checks"]["widest_logit_gap"]
    assert control["value"] > 3 * TINY_LIMIT and not res["control_correct"]
    rate = "output_tokens_per_s" + (".ssm" if "ssm" in cell else "")
    assert set(res["metrics"]) == {rate, "setup_s"}


def _stale_state(orig):
    def step(params, token, cache, cfg, ctx):
        before = _clone(cache)
        logits, _ = orig(params, token, cache, cfg, ctx)
        return logits, before
    return step


def _half_batch(orig):
    def step(params, token, cache, cfg, ctx):
        logits, cache = orig(params, token, cache, cfg, ctx)
        half = logits.shape[0] // 2
        logits = logits.clone()
        logits[half:] = logits[:logits.shape[0] - half]
        return logits, cache
    return step


# a one-token call of one request has no decode step and no batch to halve
FAULTS = [(cell, fault) for cell in ("tiny-dense.chat", "tiny-ssm.chat")
          for fault in ("stale_state", "half_batch", "altered_token")]
FAULTS.append(("tiny-dense.doc", "altered_token"))


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_faults_come_out_not_correct(tree, cell, fault, monkeypatch):
    from repro_torch.models import lm
    from repro_torch.runtime import serve_loop

    if fault == "stale_state":
        monkeypatch.setattr(lm, "decode_step", _stale_state(lm.decode_step))
    elif fault == "half_batch":
        monkeypatch.setattr(lm, "decode_step", _half_batch(lm.decode_step))
    else:
        serve = serve_loop.serve

        def altered(*a, **kw):
            out = serve(*a, **kw).clone()
            out[:, -1] = (out[:, -1] + 1) % 512
            return out
        monkeypatch.setattr(serve_loop, "serve", altered)
    res = _run(tree, cell)
    assert not res["correct"]
    assert res["checks"]["widest_logit_gap"]["value"] > TINY_LIMIT


def test_numbers_see_one_request_served_wrongly():
    # 16 requests of 64 tokens; one served wrongly throughout, its tokens
    # each 2 below the best: the mean moves by 1/8, the worst request by 2
    gaps = torch.zeros(16 * 64)
    gaps[5 * 64:6 * 64] = 2.0
    found = judge.numbers(gaps, [64] * 16)
    assert found == {"widest_logit_gap": 2.0, "mean_logit_gap": 0.125,
                     "worst_request_mean_gap": 2.0}
    checked = judge.checks(found, {"mean_logit_gap": 0.5,
                                   "worst_request_mean_gap": 1.0})
    assert not judge.holds(checked)
    assert checked["mean_logit_gap"]["value"] <= 0.5
