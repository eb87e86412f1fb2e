"""The port's paged-KV slice held against molly_tpu on the CPU, in fp32, from
the same numpy inputs: the paged attention op's plain version (against the
JAX gather reference and against the Pallas int8 kernel's body run through
the interpreter), the page-row quantizer, one paged decode step of
``forward_hidden`` with the pools compared after the write, and
``PagedServingEngine`` (greedy results token-exact against the JAX engine,
the scheduler's ``stats`` equal but for ``fetch_wait_s``, every page back on
the free list) through mixed lengths, a fusion prompt, a left-padded input,
per-request caps, preemption, the stall, the continuation bucket, the wedge,
a shared prefix and int8 pages. Tolerances: the op 2e-5, quantizer scales
1e-7, one decode step 1e-5. The JAX package keeps int8 scales as
``[Nkv, rows, 8, P]`` tiles; the port keeps ``[Nkv, rows, P]``, compared
through ``tile_to_rows``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from molly_tpu.inference.paged import PagedServingEngine as JPagedEngine
from molly_tpu.inference.paged import _pack_batch as jpack_batch
from molly_tpu.inference.paged import pages_for_budget as jpages_for_budget
from molly_tpu.inference.server import ServingEngine as JServingEngine
from molly_tpu.models import qwen3 as jqwen3
from molly_tpu.ops import paged_attention as jpaged
from molly_tpu.ops import paged_attention_int8 as jpaged8
from molly_tpu_torch.inference import paged
from molly_tpu_torch.inference.paged import PagedServingEngine
from molly_tpu_torch.inference.server import Request
from molly_tpu_torch.models import qwen3
from molly_tpu_torch.ops import paged_attention as tpaged
from test_torch_models import _tcfg_of
from test_torch_serving import (assert_released_without_gc, assert_same_run,
                                both, fusion_batch, greedy_gen, serving_setup,
                                text_batch)

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    return serving_setup()


def _engines(setup, gen, **kw):
    cfg, jp, tcfg, tp = setup
    return (JPagedEngine(jp, cfg, gen, **kw),
            PagedServingEngine(tp, tcfg, _tcfg_of(gen), **kw))


def _assert_pages_back(teng, jeng=None):
    assert len(teng._free_pages) == teng.n_pages - teng._n_shared
    assert all(not p for p in teng._slot_pages)
    if jeng is not None:  # the allocator's order is the JAX engine's
        assert teng._free_pages == jeng._free_pages


# ---------------------------------------------------------------- the op


def _op_inputs(seed, B=3, Nq=4, Nkv=2, Dh=16, P=4, PPS=4, lengths=(6, 15, 1)):
    rng = np.random.default_rng(seed)
    NP = B * PPS + 2
    q = rng.normal(size=(B, Nq, Dh)).astype(np.float32)
    kp = rng.normal(size=(Nkv, NP, P, Dh)).astype(np.float32)
    vp = rng.normal(size=(Nkv, NP, P, Dh)).astype(np.float32)
    table = rng.permutation(NP - 1)[:B * PPS].reshape(B, PPS).astype(np.int32)
    return q, kp, vp, np.asarray(lengths, np.int32), table


@pytest.mark.parametrize("group", [1, 2, 4])
def test_paged_attention_plain_matches_jax(group):
    """fp32 pages against the JAX gather reference, GQA groups 1, 2, 4,
    lengths that end inside a page."""
    q, kp, vp, lengths, table = _op_inputs(0, Nq=4, Nkv=4 // group)
    ref = jpaged.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(lengths), jnp.asarray(table), impl="xla")
    got = tpaged.paged_attention(_t(q), _t(kp), _t(vp), _t(lengths),
                                 _t(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    got = tpaged.paged_attention(_t(q), _t(kp), _t(vp), _t(lengths),
                                 _t(table), scale=0.3)
    ref = jpaged.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(lengths), jnp.asarray(table), impl="xla", scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_page_row_quantizer_and_int8_op_match_jax():
    """quantize_page_rows: identical int8, scales to 1e-7. int8 pages
    through the plain version against the JAX gather reference AND against
    the Pallas int8 kernel's body (interpret mode, as the JAX package's own
    test runs it), the JAX scales in their tile layout."""
    q, kp, vp, lengths, table = _op_inputs(3)
    kp[0, 0, 0] = 0.0  # an all-zero row: the 1e-6 floor
    jk, jks = jqwen3.quantize_page_rows(jnp.asarray(kp))
    jv, jvs = jqwen3.quantize_page_rows(jnp.asarray(vp))
    tk, tks = qwen3.quantize_page_rows(_t(kp))
    tv, tvs = qwen3.quantize_page_rows(_t(vp))
    assert tk.dtype == torch.int8 and tuple(tks.shape) == jks.shape
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tks.numpy(), np.asarray(jks), atol=1e-7,
                               rtol=0)
    kt, vt = jpaged8.scales_to_tile(jks), jpaged8.scales_to_tile(jvs)
    # the port's [Nkv, rows, P] scales are the tile's rows
    np.testing.assert_allclose(
        tks[..., 0].numpy(), np.asarray(jpaged8.tile_to_rows(kt))[..., 0],
        atol=1e-7, rtol=0)
    got = tpaged.paged_attention(
        _t(q), tk, tv, _t(lengths), _t(table),
        k_scales=tks[..., 0].contiguous(), v_scales=tvs[..., 0].contiguous())
    ref = jpaged.paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(lengths), jnp.asarray(table),
        impl="xla", k_scales=kt, v_scales=vt)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    scale = q.shape[-1] ** -0.5
    kernel = jpaged8.paged_attention_int8(
        jnp.asarray(q * scale), jk, kt, jv, vt, jnp.asarray(lengths),
        jnp.asarray(table), pages_per_compute_block=2, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), atol=2e-5,
                               rtol=2e-5)


def _bf16(*shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("case,expected", [
    ("bf16_pages", True),
    ("int8_pages", True),
    ("bf16_head_dim_64", True),
    ("int8_head_dim_64", False),
    ("fp32_pages", False),
    ("fp32_q_int8_pages", False),
    ("int8_without_scales", False),
    ("group_8", True),
    ("group_3", False),
    ("group_16", False),
    ("page_16", True),
    ("page_48", True),
    ("page_8", False),
    ("page_256", False),
    ("strided_q", True),
    ("odd_offset_q", False),
    ("q_head_stride_not_16_bytes", False),
    ("strided_pool", False),
])
def test_paged_takes_tma_rule(case, expected):
    """The TMA route's rule, on CPU tensors (dtypes, shapes, strides and
    base addresses only): bf16 q over bf16 pages (Dh 64, 128) or int8 pages
    with scales (Dh 128), G in {1, 2, 4, 8}, page size a multiple of 16 up
    to 128, contiguous pools, q strides of whole 16-byte rows."""
    B, Nkv, rows, P, Dh, G = 3, 2, 9, 64, 128, 2
    kv_dt, q_dt = torch.bfloat16, torch.bfloat16
    if case.startswith("int8") or case == "fp32_q_int8_pages":
        kv_dt, P = torch.int8, 128
    if case.endswith("head_dim_64"):
        Dh = 64
    G = {"group_8": 8, "group_3": 3, "group_16": 16}.get(case, G)
    P = {"page_16": 16, "page_48": 48, "page_8": 8,
         "page_256": 256}.get(case, P)
    if case == "fp32_pages":
        kv_dt = q_dt = torch.float32
    if case == "fp32_q_int8_pages":
        q_dt = torch.float32
    q = _bf16(B, G * Nkv, Dh, dtype=q_dt)
    if case == "strided_q":  # a slice of a wider projection
        q = _bf16(B, G * Nkv + 4, Dh)[:, :G * Nkv]
    elif case == "odd_offset_q":
        q = _bf16(B, G * Nkv, Dh + 1)[..., 1:]
    elif case == "q_head_stride_not_16_bytes":
        q = _bf16(B, G * Nkv, Dh + 4)[..., :Dh]
    k = _bf16(Nkv, rows, P, Dh, dtype=kv_dt)
    v = _bf16(Nkv, rows, P, Dh, dtype=kv_dt)
    if case == "strided_pool":
        k = _bf16(Nkv, P, rows, Dh).transpose(1, 2)
    sc = {}
    if kv_dt == torch.int8 and case != "int8_without_scales":
        sc = dict(k_scales=torch.ones((Nkv, rows, P)),
                  v_scales=torch.ones((Nkv, rows, P)))
    assert tpaged.paged_takes_tma(q, k, v, **sc) is expected


# the three 8-slot serving shapes of the smoke test: (Nkv, page size) with
# the lengths of its 8-slot cases
_LENS8 = (3136, 2900, 2047, 1531, 1000, 640, 65, 1)


@pytest.mark.parametrize("B,Nkv,P,pps", [
    (8, 8, 64, 49), (8, 8, 128, 25), (8, 4, 64, 49), (32, 8, 64, 49),
    (1, 1, 16, 3), (4, 2, 128, 1), (12, 2, 16, 196), (3, 1, 64, 1000)])
@pytest.mark.parametrize("sm_count", [132, 16])
def test_paged_split_plan_covers_every_page_once(B, Nkv, P, pps, sm_count):
    """The split plan is a function of static shapes and the SM count (no
    tensor reaches it): whole pages a split, at most the 32 table entries
    the kernel stages, and the splits of a slot cover its pages exactly
    once."""
    import inspect
    assert list(inspect.signature(tpaged.paged_split_plan).parameters) == [
        "B", "Nkv", "pages_per_seq", "page_size", "sm_count"]
    k, n = tpaged.paged_split_plan(B, Nkv, pps, P, sm_count)
    assert 1 <= k <= 32 and n == -(-pps // k)
    covered = [pg for sp in range(n) for pg in range(sp * k,
                                                     min(pps, (sp + 1) * k))]
    assert covered == list(range(pps))
    assert (k, n) == tpaged.paged_split_plan(B, Nkv, pps, P, sm_count)


@pytest.mark.parametrize("Nkv,P,pps", [(8, 64, 49), (8, 128, 25),
                                       (4, 64, 49)])
def test_paged_split_plan_fills_the_card_at_8_slots(Nkv, P, pps):
    """At the 8-slot serving shapes (1.7B bf16 and int8 pages, the MoE
    model's 4 kv heads) the splits that hold live tokens give at least two
    blocks for each of the H100's 132 SMs."""
    k, _ = tpaged.paged_split_plan(8, Nkv, pps, P, 132)
    working = Nkv * sum(-(-(-(-n // P)) // k) for n in _LENS8)
    assert working >= 2 * 132, (k, working)


def _split_merge_plain(q, k_pages, v_pages, lengths, page_indices,
                       pages_per_split, *, k_scales=None, v_scales=None):
    """The split TMA kernel's arithmetic in plain PyTorch: each split of
    ``pages_per_split`` pages gives a partial (max, sum, [G, Dh]
    accumulator) in fp32 over its live positions, and the live splits merge
    in split order; a slot without a live split gets a zero row. Only the
    order of the sums differs from ``paged_attention_plain``."""
    b, nq, dh = q.shape
    nkv, _, p, _ = k_pages.shape
    group = nq // nkv
    scale = dh ** -0.5
    pps = page_indices.shape[1]
    n_splits = -(-pps // pages_per_split)
    idx = torch.nn.functional.pad(page_indices.long(),
                                  (0, n_splits * pages_per_split - pps))
    k = k_pages[:, idx].movedim(1, 0).float()   # [B, Nkv, pages, P, Dh]
    v = v_pages[:, idx].movedim(1, 0).float()
    if k_scales is not None:
        k = k * (k_scales[:, idx].movedim(1, 0)[..., None] / tpaged.PAGED_QUANT_MAX)
        v = v * (v_scales[:, idx].movedim(1, 0)[..., None] / tpaged.PAGED_QUANT_MAX)
    s = n_splits * pages_per_split * p
    k = k.reshape(b, nkv, s, dh)
    v = v.reshape(b, nkv, s, dh)
    live = (torch.arange(s, device=q.device)[None, :]
            < torch.clamp(lengths[:, None], max=pps * p))        # [B, S]
    v = torch.where(live[:, None, :, None], v, 0.0)
    qg = q.reshape(b, nkv, group, dh).float()
    logits = torch.einsum("bngd,bnkd->bngk", qg, k) * scale
    logits = torch.where(live[:, None, None, :], logits, -torch.inf)
    logits = logits.reshape(b, nkv, group, n_splits, -1)
    m = logits.amax(-1)                                # [B, Nkv, G, splits]
    has = torch.isfinite(m)
    e = torch.exp(logits - torch.where(has, m, 0.0)[..., None])
    part_l = e.sum(-1)
    part_o = torch.einsum("bngsk,bnskd->bngsd", e,
                          v.reshape(b, nkv, n_splits, -1, dh))
    top = torch.where(has, m, -torch.inf).amax(-1)
    total_l = torch.zeros_like(top)
    total_o = torch.zeros((b, nkv, group, dh), device=q.device)
    for i in range(n_splits):  # the merge, in split order
        w = torch.where(has[..., i], torch.exp(m[..., i] - top), 0.0)
        total_l = total_l + part_l[..., i] * w
        total_o = total_o + part_o[..., i, :] * w[..., None]
    out = torch.where(total_l[..., None] > 0,
                      total_o / torch.where(total_l > 0, total_l,
                                            1.0)[..., None], 0.0)
    return out.reshape(b, nq, dh).to(q.dtype)


@pytest.mark.parametrize("pages_per_split", [1, 2, 3, 4, 6])
def test_paged_split_merge_arithmetic(pages_per_split):
    """The TMA kernel's arithmetic in plain PyTorch: partials per split
    merged in split order, with splits that cut slots at page boundaries,
    splits past a slot's length (empty), a length of 0 (a zero row) and of 1,
    against the plain version in fp32 (1e-5: only the order of the sums
    differs), over fp32 pages and over int8 pages, and the int8 result
    against the Pallas int8 kernel in interpret mode."""
    lengths = (0, 1, 4, 9, 24)
    q, kp, vp, lengths, table = _op_inputs(5, B=5, PPS=6, lengths=lengths)
    got = _split_merge_plain(
        _t(q), _t(kp), _t(vp), _t(lengths), _t(table), pages_per_split)
    ref = tpaged.paged_attention_plain(_t(q), _t(kp), _t(vp), _t(lengths),
                                       _t(table))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=0)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    jk, jks = jqwen3.quantize_page_rows(jnp.asarray(kp))
    jv, jvs = jqwen3.quantize_page_rows(jnp.asarray(vp))
    tk, tks = qwen3.quantize_page_rows(_t(kp))
    tv, tvs = qwen3.quantize_page_rows(_t(vp))
    sc = dict(k_scales=tks[..., 0].contiguous(),
              v_scales=tvs[..., 0].contiguous())
    got8 = _split_merge_plain(
        _t(q), tk, tv, _t(lengths), _t(table), pages_per_split, **sc)
    ref8 = tpaged.paged_attention_plain(_t(q), tk, tv, _t(lengths),
                                        _t(table), **sc)
    np.testing.assert_allclose(got8.numpy(), ref8.numpy(), atol=1e-5,
                               rtol=0)
    scale = q.shape[-1] ** -0.5
    kernel = jpaged8.paged_attention_int8(
        jnp.asarray(q * scale), jk, jpaged8.scales_to_tile(jks), jv,
        jpaged8.scales_to_tile(jvs), jnp.asarray(lengths),
        jnp.asarray(table), pages_per_compute_block=2, interpret=True)
    np.testing.assert_allclose(got8.numpy(), np.asarray(kernel), atol=1e-5,
                               rtol=0)


def test_paged_attention_plain_edge_rows():
    """A slot of length 0 gets a zero row (as the Pallas kernel leaves it);
    table entries and page rows past a slot's length never reach the
    result, whatever they hold."""
    q, kp, vp, lengths, table = _op_inputs(4, lengths=(6, 0, 9))
    base = tpaged.paged_attention_plain(_t(q), _t(kp), _t(vp), _t(lengths),
                                        _t(table))
    assert torch.equal(base[1], torch.zeros_like(base[1]))
    assert bool(torch.isfinite(base).all())
    table2 = table.copy()
    table2[0, 2:] = 0          # entries past ceil(6 / 4) pages
    table2[1, :] = 0
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[:, table[0, 1], 2:] = np.nan   # rows 6, 7 of slot 0's second page
    vp2[:, table[0, 1], 2:] = np.inf
    got = tpaged.paged_attention_plain(_t(q), _t(kp2), _t(vp2), _t(lengths),
                                       _t(table2))
    np.testing.assert_array_equal(got.numpy(), base.numpy())


def test_paged_attention_refuses_other_devices():
    q, kp, vp, lengths, table = _op_inputs(5)
    with pytest.raises(RuntimeError, match="unsupported device"):
        tpaged.paged_attention(_t(q).to("meta"), _t(kp), _t(vp), _t(lengths),
                               _t(table))
    assert tpaged.paged_attention.launches == 0  # the CPU never launches


@pytest.mark.parametrize("quant", [None, "int8"])
def test_pages_for_budget(quant, setup):
    """The same count as the JAX function for pages in the model dtype; for
    int8 the port stores 4 bytes of scale a row where the JAX tile stores
    32, so the same budget holds more pages."""
    cfg, _, tcfg, _ = setup
    got = paged.pages_for_budget(tcfg, 1 << 20, 4, quant)
    ref = jpages_for_budget(cfg, 1 << 20, 4, quant)
    if quant is None:
        assert got == ref
    else:
        Dh = tcfg.text.head_dim
        assert got == (1 << 20) // (2 * 4 * 2 * (Dh + 4) * 2) and got > ref


def test_pack_batch_matches_jax():
    b = {"input_ids": np.asarray([[0, 0, 5, 6, 7, 0]], np.int32),
         "attention_mask": np.asarray([[0, 0, 1, 1, 1, 0]], np.int32),
         "dna_rna_pos": np.asarray([[3, -1]], np.int32)}
    ref, got = jpack_batch(b), paged._pack_batch(b)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    with pytest.raises(ValueError):
        paged._pack_batch({"input_ids": np.asarray([[1, 2, 3]], np.int32),
                           "attention_mask": np.asarray([[1, 0, 1]],
                                                        np.int32)})


# ---------------------------------------------------------------- one step


@pytest.mark.parametrize("quant", [None, "int8"])
def test_paged_decode_step_matches_jax(setup, quant):
    """One paged ``forward_hidden`` decode step: active slots write their
    row at their own length (one across a page boundary), an inactive slot
    writes the scratch row; hidden states to 1e-5 and the pools (and
    scales) compared after the write."""
    cfg, jp, tcfg, tp = setup
    c = cfg.text
    rng = np.random.default_rng(8)
    B, P, n_pages, PPS = 3, 4, 6, 3
    L, Nkv, Dh = c.num_hidden_layers, c.num_key_value_heads, c.head_dim
    rows = L * n_pages + 1
    kp = rng.normal(size=(Nkv, rows, P, Dh)).astype(np.float32)
    vp = rng.normal(size=(Nkv, rows, P, Dh)).astype(np.float32)
    table = rng.permutation(n_pages)[:B * 2].reshape(B, 2).astype(np.int32)
    table = np.concatenate([table, np.zeros((B, PPS - 2), np.int32)], 1)
    n_real = np.array([5, 4, 3], np.int32)   # slot 1 starts a new page
    active = np.array([True, True, False])
    idx = np.where(active, n_real, -1).astype(np.int32)
    lengths = np.where(active, n_real + 1, 1).astype(np.int32)
    ids = rng.integers(1, 64, (B, 1)).astype(np.int32)
    jcache = {"page_table": jnp.asarray(table),
              "lengths": jnp.asarray(lengths)}
    tcache = {"page_table": _t(table), "lengths": _t(lengths)}
    if quant:
        jk, jks = jqwen3.quantize_page_rows(jnp.asarray(kp))
        jv, jvs = jqwen3.quantize_page_rows(jnp.asarray(vp))
        jcache.update(k_pages=jk, v_pages=jv,
                      k_scales=jpaged8.scales_to_tile(jks),
                      v_scales=jpaged8.scales_to_tile(jvs))
        tcache.update(k_pages=_t(jk), v_pages=_t(jv),
                      k_scales=_t(jks)[..., 0].contiguous(),
                      v_scales=_t(jvs)[..., 0].contiguous())
    else:
        jcache.update(k_pages=jnp.asarray(kp), v_pages=jnp.asarray(vp))
        tcache.update(k_pages=_t(kp), v_pages=_t(vp))
    kw = dict(positions=n_real[:, None], causal=False)
    jh, jc = jqwen3.forward_hidden(
        jp["text"], c, input_ids=jnp.asarray(ids),
        positions=jnp.asarray(n_real[:, None]), cache=jcache,
        cache_index=jnp.asarray(idx), causal=False)
    th, _ = qwen3.forward_hidden(
        tp["text"], tcfg.text, input_ids=_t(ids).long(),
        positions=_t(n_real[:, None]), cache=tcache, cache_index=_t(idx),
        causal=False)
    live = active[:, None, None]
    np.testing.assert_allclose(th.numpy() * live, np.asarray(jh) * live,
                               atol=ATOL)
    scratch = rows - 1  # inactive slots all write it, in either order
    for name in ("k_pages", "v_pages"):
        got, ref = tcache[name].numpy(), np.asarray(jc[name])
        if quant:
            diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
            assert diff[:, :scratch].max() <= 1  # a rounding tie at most
            assert (diff[:, :scratch] > 0).sum() <= 2
        else:
            np.testing.assert_allclose(got[:, :scratch], ref[:, :scratch],
                                       atol=ATOL)
    if quant:
        for name in ("k_scales", "v_scales"):
            ref = np.asarray(jpaged8.tile_to_rows(jc[name]))[..., 0]
            np.testing.assert_allclose(tcache[name].numpy()[:, :scratch],
                                       ref[:, :scratch], atol=1e-6)
    # the rows written: layer li of slot 0 at (table[0, 1], offset 1)
    changed = np.abs(tcache["k_pages"].numpy().astype(np.float32)
                     - (np.asarray(jk) if quant else kp)) > 0
    assert changed[:, 0 * n_pages + table[0, 1], 1].any()
    assert changed[:, 1 * n_pages + table[1, 1], 0].any()


# ---------------------------------------------------------------- the engine


def test_paged_mixed_lengths_fusion_padded_caps(setup):
    """Mixed lengths over page boundaries and two buckets, a fusion prompt
    (position keys shift with packing), a left-padded input (packed at
    admission), per-request caps, more requests than slots, chunked decode;
    against the JAX paged engine and the JAX dense ring."""
    gen = greedy_gen(7)
    specs = [(i, text_batch(s, seed=i), {}) for i, s in
             enumerate([5, 12, 16, 7])]
    specs.append(("omics", fusion_batch(), {}))
    base = text_batch(9, seed=33)
    specs.append(("padded", {
        "input_ids": np.pad(base["input_ids"], ((0, 0), (5, 0))),
        "attention_mask": np.pad(base["attention_mask"], ((0, 0), (5, 0)))},
        {}))
    specs += [(f"r{i}", text_batch(6 + i, seed=10 + i),
               {"max_new_tokens": 3 + (i % 4)}) for i in range(4)]
    kw = dict(n_slots=3, page_size=4, prefill_buckets=(8, 16),
              decode_chunk=3, admit_batch=2)
    jeng, teng = _engines(setup, gen, **kw)
    ref, got = assert_same_run(jeng, teng, specs)
    _assert_pages_back(teng, jeng)
    assert all(len(got[f"r{i}"]) == 3 + (i % 4) for i in range(4))
    cfg, jp, tcfg, tp = setup
    dense = JServingEngine(jp, cfg, gen, n_slots=3, max_len=64,
                           prefill_buckets=(16,)).run(
        both([s for s in specs if s[0] != "padded"]
             + [("padded", base, {})])[0])
    for uid in dense:
        np.testing.assert_array_equal(got[uid], dense[uid])


def test_paged_preemption_and_monotone_streaming(setup):
    """A pool too small for both long-cap requests at once: the younger is
    preempted (partial stashed, pages freed), the older finishes, the
    continuation re-prefills; results and stats equal the JAX engine's.
    The same run with stream_cb delivers monotone prefixes across the
    preemption, and a cancelled request returns its pages."""
    gen = greedy_gen(10, penalty=1.05)
    specs = [(i, text_batch(6, seed=130 + i), {}) for i in range(2)]
    kw = dict(n_slots=2, page_size=4, n_pages=6, prefill_buckets=(16,),
              decode_chunk=2)
    jeng, teng = _engines(setup, gen, **kw)
    ref, got = assert_same_run(jeng, teng, specs)
    assert teng.stats["preemptions"] >= 1
    _assert_pages_back(teng, jeng)

    cfg, jp, tcfg, tp = setup
    streamed, canceled = {}, []

    def cb(uid, toks):
        prev = streamed.setdefault(uid, [])
        if prev:
            np.testing.assert_array_equal(prev[-1], toks[:len(prev[-1])])
        prev.append(np.array(toks))
        if uid == "c" and len(toks) >= 2 and not canceled:
            canceled.append(uid)
            eng.cancel("c")

    eng = PagedServingEngine(tp, tcfg, _tcfg_of(gen), stream_cb=cb, **kw)
    results = eng.run(both(specs)[1])
    assert eng.stats["preemptions"] >= 1
    for uid, chunks in streamed.items():
        np.testing.assert_array_equal(chunks[-1], results[uid])
        np.testing.assert_array_equal(results[uid], ref[uid])
    out = eng.run([Request(uid="c", batch=text_batch(10, seed=42))])
    assert 2 <= len(out["c"]) < 10
    _assert_pages_back(eng)


@pytest.mark.parametrize("n_pages,cont_bucket,expect", [
    (11, False, "stall"), (10, True, "continuation"), (10, False, "wedge")])
def test_paged_stall_continuation_bucket_and_wedge(setup, n_pages,
                                                   cont_bucket, expect):
    """Prompts that fill the only workload bucket, so that no continuation
    fits it. Pool 11 without the continuation bucket: the grower STALLS
    (keeps its pages, frozen for the round) and resumes when the other slot
    finishes. Pool 10 with the auto continuation bucket: one slot is
    preempted and re-prefills prompt + stash through the big bucket (sized
    from the rounded table width). Pool 10 without it: every in-flight slot
    is stalled, nothing is preemptible: both engines raise."""
    gen = greedy_gen(24, penalty=1.05)
    caps = (8, 24) if expect == "stall" else (None, None)
    specs = [(i, text_batch(16, seed=60 + i), {"max_new_tokens": c})
             for i, c in enumerate(caps)]
    kw = dict(n_slots=2, page_size=4, n_pages=n_pages,
              prefill_buckets=(16,), decode_chunk=4,
              continuation_bucket=cont_bucket)
    jeng, teng = _engines(setup, gen, **kw)
    assert teng._cont_bucket == jeng._cont_bucket
    assert teng.buckets == jeng.buckets
    if expect == "wedge":
        jreqs, treqs = both(specs)
        with pytest.raises(RuntimeError, match="wedged"):
            jeng.run(jreqs)
        with pytest.raises(RuntimeError, match="wedged"):
            teng.run(treqs)
        return
    ref, got = assert_same_run(jeng, teng, specs)
    _assert_pages_back(teng, jeng)
    if expect == "stall":
        assert teng.stats["stalls"] >= 1 and not teng._stalled
        assert teng.stats["preemptions"] == 0
    else:
        assert teng._cont_bucket > 16
        assert teng.stats["preemptions"] >= 1


@pytest.mark.parametrize("quant", [None, "int8"])
def test_paged_shared_prefix_pages(setup, quant):
    """A shared prefix of 10 tokens at page size 4: two full pages are
    pinned and shared by every slot's table, the remainder rides each
    suffix (the prefill's flash call has q_offset = 8 and a right-padded
    mask); with an oversubscribed pool, so that a continuation re-strips
    the prefix."""
    gen = greedy_gen(10, penalty=1.0)
    rng = np.random.default_rng(5)
    prefix = rng.integers(1, 64, 10).astype(np.int32)
    specs = []
    for i, s in enumerate([3, 7, 5]):
        ids = np.concatenate(
            [prefix[None], rng.integers(1, 64, (1, s)).astype(np.int32)], 1)
        specs.append((i, {"input_ids": ids,
                          "attention_mask": np.ones_like(ids)}, {}))
    kw = dict(n_slots=3, page_size=4, n_pages=9, prefill_buckets=(16,),
              decode_chunk=2, prefix_ids=prefix, kv_quant=quant)
    jeng, teng = _engines(setup, gen, **kw)
    assert teng.s_pre == 8 and teng._n_shared == 2
    assert teng._shared_pages == jeng._shared_pages
    assert_same_run(jeng, teng, specs, int8_flips=3 if quant else None)
    assert teng.stats["preemptions"] >= 1
    _assert_pages_back(teng, jeng)
    with pytest.raises(ValueError, match="prefix"):
        teng.run([Request(uid=0, batch=text_batch(12, seed=3))])


def test_paged_int8_pages_engine(setup):
    """int8 pages + per-row scales: pools int8, scales [Nkv, rows, P];
    greedy tokens against the JAX int8 engine (exact in fp32 but for a
    rounding tie: within the JAX test's own allowance of 3 flips, first
    tokens exact)."""
    gen = greedy_gen(6, penalty=1.0)
    specs = [(i, text_batch(s, seed=10 + i), {}) for i, s in
             enumerate([5, 12, 7])]
    kw = dict(n_slots=3, page_size=4, prefill_buckets=(8, 16),
              kv_quant="int8")
    jeng, teng = _engines(setup, gen, **kw)
    assert teng.hot["k_pages"].dtype == torch.int8
    assert tuple(teng.hot["k_scales"].shape) == \
        tuple(teng.hot["k_pages"].shape[:3])
    ref, got = assert_same_run(jeng, teng, specs, int8_flips=3)
    assert all(got[u][0] == ref[u][0] for u in ref)
    _assert_pages_back(teng, jeng)
    # the pools agree after the run: same rows quantized to the same bytes
    jk = np.asarray(jeng.hot["k_pages"]).astype(np.int32)
    tk = teng.hot["k_pages"].numpy().astype(np.int32)
    scratch = tk.shape[1] - 1
    assert (np.abs(jk - tk)[:, :scratch] > 1).sum() == 0
    np.testing.assert_allclose(
        teng.hot["k_scales"].numpy()[:, :scratch],
        np.asarray(jpaged8.tile_to_rows(jeng.hot["k_scales"]))[
            :, :scratch, :, 0], atol=1e-5)


def test_paged_allocator_keeps_chains_disjoint(setup):
    """The page writer relies on no two slots sharing a writable page; the
    allocator asserts it where the chains are known."""
    cfg, jp, tcfg, tp = setup
    eng = PagedServingEngine(tp, tcfg, _tcfg_of(greedy_gen(4)), n_slots=2,
                             page_size=4, n_pages=8, prefill_buckets=(16,))
    assert eng._alloc(0) == []  # never slices by -0
    first = eng._alloc(3)
    assert first == [5, 6, 7] and eng._free_pages == [0, 1, 2, 3, 4]
    eng._slot_pages[0] = first
    eng._free_pages.append(6)  # a page on the free list AND in a chain
    with pytest.raises(AssertionError):
        eng._alloc(1)


def test_dropped_paged_engine_frees_its_pool_without_gc(setup):
    cfg, jp, tcfg, tp = setup
    assert_released_without_gc(
        lambda: PagedServingEngine(tp, tcfg, _tcfg_of(greedy_gen(4)),
                                   n_slots=2, page_size=4, n_pages=16,
                                   prefill_buckets=(16,), decode_chunk=2,
                                   time_phases=True,
                                   stream_cb=lambda uid, toks: None),
        "k_pages")
