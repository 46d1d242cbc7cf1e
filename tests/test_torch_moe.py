"""The expert-parallel MoE layer (``tpuspmm_torch/ops/moe.py``) against the
plain reference of DeepSeek-V3's FFN side
(``spmm_bench/models/deepseek_v3_moe.py``), at a small size on the CPU.

The weights are seeded pruned BSRs (32 × 32 blocks at half density, which
K6's path packs into 128 × 128 blocks); the reference gets them dense.

Tolerances, each with its reason:

- f32 tokens: max |out − ref| / max |ref| ≤ F32_LIMIT.  Every product is
  K6's plain version, whose f32 A is split into three bf16 terms, against
  f32 products: a few 1e-7 of the largest output.  Rounding the experts'
  weights to bf16 (the control, one precision below the configuration's
  f32 A) moves the output by about 3e-3.
- bf16 tokens: ‖out − ref‖ / ‖ref‖ ≤ BF16_NORM_LIMIT.  Both round h, the
  hidden activations, to bf16 between the products, from f32 values that
  differ by a few 1e-7; where one lands on each side of a rounding
  boundary the two h differ by one bf16 step, which moves a few outputs by
  up to ~3e-4 of the largest (1.3e-3 on the card), so the largest gap is
  a loose test at this precision.  Those steps are rare, and their share
  of the norm stays near 6e-5; rounding every weight to bf16 moves the
  norm by about 4e-3.  The largest gap is held too, at BF16_MAX_LIMIT,
  set between one seed's readings on the card (the layer's 1.30e-3, the
  control's 4.58e-3); here they read 2.1e-5 and 3.8e-3.
"""

import os
import subprocess
import sys

import pytest
import torch

from spmm_bench.models import deepseek_v3_moe as ref
from tpuspmm_torch import BSR, Config, Expert, Routing, moe
from tpuspmm_torch.ops import moe as moe_mod
from tpuspmm_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

F32_LIMIT = 1e-5
BF16_NORM_LIMIT = 1e-3
BF16_MAX_LIMIT = 2.5e-3

HIDDEN, WIDTH, EXPERTS, TOKENS = 256, 128, 16, 64
CONFIG = {"n_group": 4, "topk_group": 2, "num_experts_per_tok": 4,
          "norm_topk_prob": True, "routed_scaling_factor": 2.5}
CPU = Config(device="cpu")


def _expert(seed: int) -> Expert:
    return Expert(*(BSR.random_blocks(r, c, (32, 32), 0.5, seed + i)
                    for i, (r, c) in enumerate(((WIDTH, HIDDEN),
                                                (WIDTH, HIDDEN),
                                                (HIDDEN, WIDTH)))))


def _dense(expert: Expert, dtype=torch.float32) -> tuple:
    return tuple(torch.from_numpy(w.to_dense()).to(dtype).float()
                 for w in (expert.gate, expert.up, expert.down))


@pytest.fixture(scope="module")
def layer():
    """Router, bias, 16 routed experts, the shared expert and 64 tokens,
    drawn from seeds."""
    g = torch.Generator().manual_seed(21)
    router = torch.randn(EXPERTS, HIDDEN, generator=g) / HIDDEN ** 0.5
    bias = torch.rand(EXPERTS, generator=g) * 0.1
    x = torch.randn(TOKENS, HIDDEN, generator=g) * 0.05
    experts = {e: _expert(10 * e) for e in range(EXPERTS)}
    return {"router": router, "bias": bias, "x": x, "experts": experts,
            "shared": _expert(1000)}


def _port(layer, x, held=None, own=None, shared=True):
    held = range(EXPERTS) if held is None else held
    return moe(x, layer["router"], layer["bias"],
               {e: layer["experts"][e] for e in held},
               Routing.from_config(CONFIG),
               layer["shared"] if shared else None, own=own, config=CPU)


def _reference(layer, x, dtype=torch.float32):
    """The whole layer, weights rounded to ``dtype`` (f32: as drawn)."""
    return ref.moe_share(x, layer["router"], layer["bias"],
                         {e: _dense(w, dtype)
                          for e, w in layer["experts"].items()},
                         CONFIG, _dense(layer["shared"], dtype))


def _max_rel(out, want):
    return float((out - want).abs().max() / want.abs().max())


def _norm_rel(out, want):
    return float((out - want).norm() / want.norm())


def test_f32_layer_matches_the_reference(layer):
    out = _port(layer, layer["x"])
    assert out.dtype == torch.float32 and out.shape == (TOKENS, HIDDEN)
    assert _max_rel(out, _reference(layer, layer["x"])) <= F32_LIMIT


def test_bf16_layer_matches_the_reference(layer):
    x = layer["x"].to(torch.bfloat16)
    out, want = _port(layer, x), _reference(layer, x)
    assert _norm_rel(out, want) <= BF16_NORM_LIMIT
    assert _max_rel(out, want) <= BF16_MAX_LIMIT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bf16_weights_miss_the_limits(layer, dtype):
    """The control: the reference with every expert weight rounded to bf16
    misses the limit of its token dtype."""
    x = layer["x"].to(dtype)
    want = _reference(layer, x)
    control = _reference(layer, x, torch.bfloat16)
    if dtype == torch.float32:
        assert _max_rel(control, want) > 10 * F32_LIMIT
    else:
        assert _norm_rel(control, want) > 2 * BF16_NORM_LIMIT
        assert _max_rel(control, want) > BF16_MAX_LIMIT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_slab_reaches_spmm_padded_to_a_multiple_of_8(layer, monkeypatch,
                                                          dtype):
    """Routed widths are any count; each product's B is padded with zero
    columns to a multiple of PAD (8), which changes no kept column: the
    layer equals itself unpadded (PAD 1)."""
    from tpuspmm_torch.ops import api

    x = layer["x"].to(dtype)
    chosen, _ = ref.route(x, layer["router"], layer["bias"], CONFIG)
    loads = torch.bincount(chosen.flatten(), minlength=EXPERTS).tolist()
    assert any(n % moe_mod.PAD for n in loads)
    widths = []
    served = api.spmm

    def spmm(a, b, **kw):
        widths.append(b.shape[1])
        return served(a, b, **kw)

    monkeypatch.setattr(api, "spmm", spmm)
    out = _port(layer, x)
    assert moe_mod.PAD == 8 and widths
    assert all(w % 8 == 0 for w in widths)
    assert sorted(set(widths)) == sorted({-(-n // 8) * 8 for n in loads + [
        TOKENS] if n})
    monkeypatch.setattr(moe_mod, "PAD", 1)
    assert torch.equal(out, _port(layer, x))


def test_the_shares_of_every_chip_add_up_to_the_whole_layer(layer):
    """Four chips of four experts each, each adding the shared expert on
    its own quarter of the tokens: their sum is the uncut layer."""
    x = layer["x"]
    quarter = TOKENS // 4
    shares = [_port(layer, x, held=range(4 * c, 4 * c + 4),
                    own=slice(quarter * c, quarter * (c + 1)))
              for c in range(4)]
    whole = _reference(layer, x)
    assert _max_rel(sum(shares), whole) <= F32_LIMIT
    # the reference's own shares add up the same way
    ref_shares = [ref.moe_share(
        x, layer["router"], layer["bias"],
        {e: _dense(layer["experts"][e]) for e in range(4 * c, 4 * c + 4)},
        CONFIG, _dense(layer["shared"]),
        own=slice(quarter * c, quarter * (c + 1))) for c in range(4)]
    assert _max_rel(sum(ref_shares), whole) <= 1e-6


def test_a_held_expert_no_token_chose_is_skipped(layer):
    """An expert the bias keeps out of every choice serves no call; the
    share is the reference's, and the counter adds only the tokens
    served."""
    bias = layer["bias"].clone()
    bias[3] = -10.0
    x = layer["x"]
    chosen, _ = ref.route(x, layer["router"], bias, CONFIG)
    assert not bool((chosen == 3).any())
    busy = int(torch.bincount(chosen.flatten(), minlength=EXPERTS).argmax())
    held = {e: layer["experts"][e] for e in (busy, 3)}
    before = profiling.snapshot().get(moe_mod.TOKENS_COUNTER, (0, 0.0))[0]
    out = moe(x, layer["router"], bias, held, Routing.from_config(CONFIG),
              config=CPU)
    after = profiling.snapshot()[moe_mod.TOKENS_COUNTER][0]
    assert after - before == int((chosen == busy).sum()) > 0
    want = ref.moe_share(x, layer["router"], bias,
                         {e: _dense(w) for e, w in held.items()}, CONFIG)
    assert _max_rel(out, want) <= F32_LIMIT


def _port_route(x, weight, bias, config):
    return moe_mod.route(x, weight, bias, Routing.from_config(config))


ROUTES = pytest.mark.parametrize("route", [_port_route, ref.route],
                                 ids=["port", "reference"])


def _scored(logits):
    """One token whose router logits are ``logits``: x = ones, Wr =
    diag(logits)."""
    logits = torch.tensor(logits, dtype=torch.float32)
    return torch.ones(1, len(logits)), torch.diag(logits)


@ROUTES
def test_routing_keeps_the_best_groups_only(route):
    """Groups of two: group 0 holds the best expert (logit 3) beside a weak
    one, so its top-2 sum (0.953 + 0.047) is below groups 1 and 2 (2 ·
    0.731, 0.711 + 0.690): with two groups kept, expert 0 is not chosen."""
    x, w = _scored([3.0, -3.0, 1.0, 1.0, 0.9, 0.8, -1.0, -1.0])
    config = dict(CONFIG, n_group=4, topk_group=2, num_experts_per_tok=3)
    chosen, _ = route(x, w, torch.zeros(8), config)
    assert sorted(chosen[0].tolist()) == [2, 3, 4]


@ROUTES
def test_routing_uses_the_bias_only_to_choose(route):
    """The bias lifts expert 3 (logit -1) above expert 1 (logit 1); its
    weight is its unbiased score, sigmoid(-1), normalised with expert
    0's sigmoid(2) and times 2.5."""
    x, w = _scored([2.0, 1.0, 0.0, -1.0])
    config = dict(CONFIG, n_group=1, topk_group=1, num_experts_per_tok=2)
    chosen, weights = route(x, w, torch.tensor([0.0, 0.0, 0.0, 5.0]),
                            config)
    got = dict(zip(chosen[0].tolist(), weights[0].tolist()))
    s0, s3 = torch.sigmoid(torch.tensor([2.0, -1.0])).tolist()
    assert set(got) == {0, 3}
    assert got[0] == pytest.approx(2.5 * s0 / (s0 + s3), rel=1e-6)
    assert got[3] == pytest.approx(2.5 * s3 / (s0 + s3), rel=1e-6)


@ROUTES
@pytest.mark.parametrize("norm", [True, False])
def test_routing_scales_the_weights_by_2_5(route, norm):
    """Normalised, the chosen weights sum to routed_scaling_factor;
    without ``norm_topk_prob`` each is 2.5 times its score."""
    x, w = _scored([0.5, -0.5, 1.5, 0.0])
    config = dict(CONFIG, n_group=2, topk_group=2, num_experts_per_tok=2,
                  norm_topk_prob=norm)
    chosen, weights = route(x, w, torch.zeros(4), config)
    assert sorted(chosen[0].tolist()) == [0, 2]
    scores = torch.sigmoid(torch.tensor([0.5, 1.5]))
    want = 2.5 * (scores / scores.sum() if norm else scores)
    got = torch.tensor(sorted(weights[0].tolist()))
    assert torch.allclose(got, want, rtol=1e-6)


def test_the_layer_spans_and_counter_appear_in_the_snapshot(layer):
    """Under a profiler the route, gather and combine spans run; the tokens
    counter rises by the (token, held expert) pairs served."""
    x = layer["x"]
    chosen, _ = ref.route(x, layer["router"], layer["bias"], CONFIG)
    loads = torch.bincount(chosen.flatten(), minlength=EXPERTS)
    held = sorted(loads.argsort(descending=True)[:3].tolist())
    pairs = sum(int((chosen == e).sum()) for e in held)
    names = ("tpuspmm_torch.moe.route", "tpuspmm_torch.moe.gather",
             "tpuspmm_torch.moe.combine", moe_mod.TOKENS_COUNTER)
    before = profiling.snapshot()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _port(layer, x, held=held)
    after = profiling.snapshot()
    rose = {n: after[n][0] - before.get(n, (0, 0.0))[0] for n in names}
    assert rose["tpuspmm_torch.moe.route"] == 1
    assert rose["tpuspmm_torch.moe.gather"] >= 1 + len(held)
    assert rose["tpuspmm_torch.moe.combine"] >= 1
    assert rose[moe_mod.TOKENS_COUNTER] == pairs


def _loaded_after(module: str) -> list:
    code = ("import sys; import {0}; print(sorted({{m.split('.')[0] "
            "for m in sys.modules}}))").format(module)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    return eval(out.stdout.strip().splitlines()[-1])


def test_the_layer_imports_neither_jax_nor_the_jax_package():
    loaded = _loaded_after("tpuspmm_torch.ops.moe")
    assert "tpuspmm_torch" in loaded
    assert not {"jax", "jaxlib", "tpuspmm"} & set(loaded)


def test_the_reference_imports_nothing_of_the_program_nor_jax():
    loaded = _loaded_after("spmm_bench.models.deepseek_v3_moe")
    assert not {"jax", "jaxlib", "tpuspmm", "tpuspmm_torch"} & set(loaded)
