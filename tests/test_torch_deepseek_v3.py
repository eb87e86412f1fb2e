"""The port's DeepSeek-V3-family decoder (``models.deepseek_v3``: latent
attention over a compressed cache, sigmoid-routed experts beside shared
ones) held against the benchmark's plain float32 reference
(``h100_bench/reference/deepseek_v3.py``, itself held against HF
transformers in ``test_torch_deepseek_v3_hf.py``), on the CPU in float32
at tiny sizes: the full forward, prefill and decode through the latent
cache under left padding, the router, the flash wrapper's plain version
at unequal head widths, and ``inference.cli.run_batches`` end to end. It
has no JAX original. The card's kernel at 192 / 128 is held against the
plain version under ``-m cuda``.

Tolerances: logits agree to 1e-5 of their largest magnitude (~0.6), where
float32 on both sides leaves ~3e-7 (the order of sums) and one bf16
rounding anywhere leaves ~4e-3."""

from __future__ import annotations

import copy
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from h100_bench.harness.weights import _Draw
from h100_bench.reference import deepseek_v3 as ref
from molly_tpu_torch.models import decoders, deepseek_v3, qwen3
from molly_tpu_torch.models.configs import (DeepseekV3Config, tiny_deepseek_v3,
                                            tiny_qwen3)
from molly_tpu_torch.ops import moe
from molly_tpu_torch.ops.flash_attention import (bwd_takes_tma,
                                                 flash_attention_plain,
                                                 fwd_takes_tma)
from molly_tpu_torch.utils import profiling

REL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """The tensors here are tiny: one intra-op thread, as the suite runs
    several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(seed=0, **kw):
    cfg = tiny_deepseek_v3(**kw)
    params = deepseek_v3.init_params(cfg, torch.Generator().manual_seed(seed))
    return cfg, params, dataclasses.asdict(cfg)


def _close(a, b):
    assert a.shape == b.shape
    err, top = float((a - b).abs().max()), float(b.abs().max())
    assert err <= REL * top, (err, top)


def test_the_full_forward_matches_the_reference():
    cfg, params, text = _setup()
    g = torch.Generator().manual_seed(1)
    embeds = torch.randn(2, 13, cfg.hidden_size, generator=g)
    hidden, _ = deepseek_v3.forward_hidden(params, cfg, inputs_embeds=embeds)
    logits = deepseek_v3.logits_from_hidden(params, cfg, hidden)
    want = ref.decoder_logits(params, text, list(embeds),
                              [(0, 13), (0, 13)])
    for a, b in zip(logits, want):
        _close(a, b)


def test_prefill_then_decode_through_the_latent_cache():
    """Left-padded rows of 4, 7 and 11 real tokens, prefill at the
    engine's left-pad-aware positions, then 8 decode steps through the
    cache (the absorbed form), each step's logits against the reference's
    full forward over the row's prompt and the tokens fed. The cache is
    [L, B, S + T, latent_dim]; every decode layer reads the latents
    (``molly/mla/absorb``) and decompresses nothing."""
    cfg, params, text = _setup(seed=2)
    lens, S, T = (4, 7, 11), 11, 8
    B, H = len(lens), cfg.hidden_size
    g = torch.Generator().manual_seed(3)
    rows = [torch.randn(n, H, generator=g) for n in lens]
    x = torch.zeros(B, S, H)
    mask = torch.zeros(B, S + T, dtype=torch.int32)
    for b, n in enumerate(lens):
        x[b, S - n:] = rows[b]
        mask[b, S - n:S] = 1
    positions = torch.clamp(torch.cumsum(mask[:, :S], 1) - 1, min=0)
    fed = torch.randint(0, cfg.vocab_size, (B, T - 1), generator=g)
    col = torch.arange(S + T)[None]
    stats = {}
    with torch.inference_mode(), profiling.recording(stats):
        cache = deepseek_v3.init_cache(cfg, B, S + T)
        hidden, cache = deepseek_v3.forward_hidden(
            params, cfg, inputs_embeds=x, attention_mask=mask,
            positions=positions, cache=cache, cache_index=0)
        got = [deepseek_v3.logits_from_hidden(params, cfg, hidden[:, -1])]
        for j in range(T - 1):
            step_mask = torch.where(col < S, mask,
                                    (col <= S + j).to(torch.int32))
            hidden, cache = deepseek_v3.forward_hidden(
                params, cfg,
                inputs_embeds=deepseek_v3.embed_tokens(params,
                                                       fed[:, j:j + 1]),
                attention_mask=step_mask,
                positions=(torch.tensor(lens) + j)[:, None], cache=cache,
                cache_index=S + j)
            got.append(deepseek_v3.logits_from_hidden(params, cfg,
                                                      hidden[:, 0]))
    L = cfg.num_hidden_layers
    assert cache["kv"].shape == (L, B, S + T, cfg.kv_lora_rank
                                 + cfg.qk_rope_head_dim)
    assert stats["counts"]["mla_cache_bytes"] == L * B * (S + T) * 40 * 4
    assert stats["spans"]["molly/mla/absorb"]["n"] == L * (T - 1)
    assert stats["spans"]["molly/mla/decompress"]["n"] == L
    full = [torch.cat([rows[b], params["embed"][fed[b]]]) for b in range(B)]
    want = ref.decoder_logits(params, text, full,
                              [(n - 1, n - 1 + T) for n in lens])
    got = torch.stack(got, 1)
    for b in range(B):
        _close(got[b], want[b])


def test_the_reference_draws_the_program_tree():
    """The benchmark's weights (``draw``) have the program's tree: the
    same leaves, shapes and dtypes as ``init_params``."""
    cfg, params, text = _setup()
    drawn = ref.draw(_Draw(4, "cpu", torch.float32), text)

    def leaves(t, pre=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, pre + k + "/")
            else:
                yield pre + k, tuple(v.shape), v.dtype

    assert sorted(leaves(drawn)) == sorted(leaves(params))
    assert drawn["moe"]["correction_bias"].abs().min() > 0


def test_the_sigmoid_router_chooses_by_the_bias_and_weighs_without_it():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(9, 16, generator=g)
    w = torch.randn(16, 8, generator=g) * 0.3
    bias = torch.zeros(8)
    bias[7] = 10.0  # expert 7 is always chosen
    scale = 2.446
    topw, topi, probs, _ = moe.router_topk(
        x, w, 3, True, scoring="sigmoid", correction_bias=bias,
        routed_scale=scale)
    assert (topi == 7).any(-1).all()
    scores = torch.sigmoid(x @ w)
    torch.testing.assert_close(probs, scores, rtol=0, atol=1e-6)
    chosen = scores.gather(1, topi)
    torch.testing.assert_close(topw, chosen / chosen.sum(-1, keepdim=True)
                               * scale, rtol=1e-6, atol=0)
    # without the bias the unbiased top 3 are chosen
    _, plain_i, _, _ = moe.router_topk(x, w, 3, True, scoring="sigmoid")
    assert torch.equal(plain_i.sort(-1).values,
                       scores.topk(3, -1).indices.sort(-1).values)
    assert not torch.equal(plain_i.sort(-1).values, topi.sort(-1).values)


def test_the_softmax_router_and_moe_mlp_are_unchanged():
    """Qwen3-MoE's router is the softmax top-k of before, bit for bit, and
    ``moe_mlp`` is that router followed by ``moe_experts``."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn(10, 16, generator=g).to(torch.bfloat16)
    w = (torch.randn(16, 4, generator=g) * 0.3).to(torch.bfloat16).float()
    topw, topi, probs, logits = moe.router_topk(x, w, 2, True)
    want_logits = x.float() @ w
    want_probs = torch.softmax(want_logits, dim=-1)
    want_w, want_i = torch.topk(want_probs, 2, dim=-1)
    want_w = want_w / want_w.sum(dim=-1, keepdim=True)
    for a, b in ((logits, want_logits), (probs, want_probs), (topw, want_w),
                 (topi, want_i)):
        assert torch.equal(a, b)
    wg, wu = (torch.randn(4, 16, 8, generator=g) * 0.1 for _ in range(2))
    wd = torch.randn(4, 8, 16, generator=g) * 0.1
    xf = x.float()
    out, aux = moe.moe_mlp(xf, w, wg, wu, wd, num_experts_per_tok=2)
    tw, ti, _, _ = moe.router_topk(xf, w, 2, True)
    experts, counts = moe.moe_experts(xf, tw, ti, wg, wu, wd)
    assert torch.equal(out, experts) and aux is not None
    assert int(counts.sum()) == 10 * 2


def test_the_shared_experts_are_added_once():
    """An MoE layer's FFN is the routed experts' sum plus the shared
    SwiGLU: with the routed experts' down projections zero it is the shared
    SwiGLU alone, and with the shared one's zero the routed sum alone."""
    cfg, params, _ = _setup(seed=7)
    x = torch.randn(2, 5, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(8))
    moe_layers = deepseek_v3._unstack_layers(params["moe"], 2)
    m = dict(moe_layers[0])
    shared = (F.silu(x @ m["shared_gate"]) * (x @ m["shared_up"])) \
        @ m["shared_down"]
    both = deepseek_v3._mlp(cfg, x, 1, [], [m])
    m_routed_off = dict(m, expert_down=torch.zeros_like(m["expert_down"]))
    torch.testing.assert_close(
        deepseek_v3._mlp(cfg, x, 1, [], [m_routed_off]), shared, rtol=0,
        atol=1e-7)
    m_shared_off = dict(m, shared_down=torch.zeros_like(m["shared_down"]))
    routed = deepseek_v3._mlp(cfg, x, 1, [], [m_shared_off])
    torch.testing.assert_close(both, routed + shared, rtol=0, atol=1e-6)
    assert routed.abs().max() > 1e-3 and shared.abs().max() > 1e-3


def test_flash_plain_at_unequal_widths_matches_direct_math():
    """The flash wrapper's plain version at q.k 192 / v 128, causal, left
    padded, against the softmax written out; fp32 on both sides (measured
    ~1e-7). The rule sends aligned bf16 of these widths to the TMA
    kernel, and the backward keeps one width."""
    g = torch.Generator().manual_seed(9)
    B, S, N, D, Dv = 2, 20, 3, 192, 128
    q, k = (torch.randn(B, S, N, D, generator=g) for _ in range(2))
    v = torch.randn(B, S, N, Dv, generator=g)
    mask = torch.ones(B, S, dtype=torch.int32)
    mask[1, :6] = 0
    scale = D ** -0.5
    o, lse = flash_attention_plain(q, k, v, mask, True, scale)
    s = torch.einsum("bqnd,bknd->bnqk", q, k) * scale
    keep = (mask[:, None, None, :] != 0) & torch.ones(
        S, S, dtype=torch.bool).tril()
    s = s.masked_fill(~keep, float("-inf"))
    want = torch.einsum("bnqk,bknd->bqnd", s.softmax(-1), v)
    assert o.shape == (B, S, N, Dv)
    live = torch.ones(B, S, dtype=torch.bool)
    live[1, :6] = False  # rows with no valid key: no caller reads them
    torch.testing.assert_close(o[live], want[live], rtol=0, atol=1e-5)
    torch.testing.assert_close(lse.transpose(1, 2)[live],
                               torch.logsumexp(s, -1).transpose(1, 2)[live],
                               rtol=0, atol=1e-5)
    bf = [t.to(torch.bfloat16) for t in (q, k, v, o)]
    assert fwd_takes_tma(*bf)
    assert not bwd_takes_tma(bf[0], bf[1], bf[2], bf[0])
    assert not fwd_takes_tma(bf[0], bf[1], bf[0], bf[0])  # 192 / 192


def test_the_decoder_lookup_and_the_config_rules():
    assert decoders.of(tiny_qwen3()) is qwen3
    assert decoders.of(tiny_deepseek_v3()) is deepseek_v3
    with pytest.raises(TypeError, match="no decoder"):
        decoders.of(object())
    for bad in (dict(n_group=8, topk_group=4), dict(q_lora_rank=1536),
                dict(scoring_func="softmax")):
        with pytest.raises(ValueError, match="not supported"):
            DeepseekV3Config(**bad)


def test_run_batches_end_to_end_on_the_latent_decoder(tmp_path):
    """``inference.cli.run_batches`` over a tiny fusion model with this
    decoder, as ``h100_bench/drivers/batch_generate.py`` runs it (the same
    encoders, injection and sampling): its greedy tokens' logits are the
    float32 reference's best (gap 0 within the 1e-8 float32 allows), half
    the batches sampled."""
    from h100_bench.tests.tiny import TINY_CONFIG, make_bench, run_tiny
    config = copy.deepcopy(TINY_CONFIG)
    config.update(name="tiny-ds", decoder="deepseek_v3",
                  text=TINY_DEEPSEEK_TEXT)
    bench = make_bench(tmp_path, config=config, name="tds.eval")
    _, out = run_tiny(bench, name="tds.eval", seed=2 ** 31 + 5)
    (name, gap, limit), = out.checks
    assert name == "mean_sq_logit_gap" and gap <= 1e-8 and out.correct
    assert out.attempted == 4 and out.failed == 0


def test_the_moonlight_config_file_runs_the_published_config():
    """``configs/molly-moonlight-16b-a3b.json`` states the published
    config.json at its top level and again under ``text``, which the
    harness builds the program's config from: the two agree key for key,
    ``num_experts`` is ``n_routed_experts``, and the text config the
    harness builds is the port's Moonlight default."""
    from h100_bench.harness.cell import load_cell
    cell = load_cell("molly-moonlight-16b-a3b.eval")
    c, text = cell.config, dict(cell.config["text"])
    assert text.pop("num_experts") == c["n_routed_experts"]
    assert {k: c.get(k, "absent") for k in text} == text
    assert cell.fusion_config().text == DeepseekV3Config()


# a tiny configuration file's text, under the published config's keys
TINY_DEEPSEEK_TEXT = {
    "vocab_size": 512, "hidden_size": 64, "intermediate_size": 96,
    "moe_intermediate_size": 16, "num_hidden_layers": 3,
    "num_attention_heads": 4, "num_key_value_heads": 4, "q_lora_rank": None,
    "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
    "v_head_dim": 16, "n_routed_experts": 8, "num_experts": 8,
    "num_experts_per_tok": 2, "n_shared_experts": 2,
    "first_k_dense_replace": 1, "scoring_func": "sigmoid",
    "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
    "norm_topk_prob": True, "routed_scaling_factor": 2.446,
    "rms_norm_eps": 1e-5, "rope_theta": 50000, "tie_word_embeddings": False,
    "max_position_embeddings": 8192}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_the_tma_kernel_at_192_128_matches_the_plain_version(card):
    """bf16 q [2, 700, 16, 192] over k [.., 800, 16, 192] and a strided v
    [.., 128] (the decompressed kv's half), causal, left padded: O within
    2e-2 (the table's flash tolerance) of the plain version on rows with a
    valid key, padded rows exactly 0, two runs bit-equal."""
    from molly_tpu_torch.ops.flash_attention import flash_attention_fwd
    g = torch.Generator(device="cuda").manual_seed(10)
    B, S, Skv, N = 2, 700, 800, 16
    q = torch.randn(B, S, N, 192, generator=g, device="cuda").bfloat16()
    k = torch.randn(B, Skv, N, 192, generator=g, device="cuda").bfloat16()
    v = torch.randn(B, Skv, N, 256, generator=g,
                    device="cuda").bfloat16()[..., 128:]
    mask = torch.zeros(B, Skv, dtype=torch.int32, device="cuda")
    mask[0, :S] = 1
    mask[1, 333:S] = 1
    before = flash_attention_fwd.launches_tma
    o, lse = flash_attention_fwd(q, k, v, mask, True, 192 ** -0.5)
    o2, _ = flash_attention_fwd(q, k, v, mask, True, 192 ** -0.5)
    assert flash_attention_fwd.launches_tma == before + 2
    po, _ = flash_attention_plain(q, k, v, mask, True, 192 ** -0.5)
    live = torch.cumsum(mask[:, :S], 1) > 0
    assert (o.float() - po.float()).abs()[live].max() <= 2e-2
    assert o[~live].abs().max() == 0 and torch.equal(o, o2)
