"""``molly_tpu_torch.parallel.sharding`` held against ``molly_tpu.parallel``:
the spec rules leaf for leaf over every tree kind, the rank -> coordinate
map of ``make_mesh`` (``dcn_data`` included), ``host_shard_range``, the
fusion model's loss and gradients under (fsdp=2, tensor=2), (tensor=4:
heads that do not divide over the axis), (dcn_data=2, fsdp=2) and QLoRA
against the JAX package's unsharded ones, and sharded greedy decode
token for token. The JAX side runs here on the 8 virtual CPU devices of
``tests/conftest.py``; the port's side in gloo ranks spawned once for the
module (``parallel.launch.run_ranks``), on the same numpy inputs. fp32;
tolerances beside each comparison."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_parallel_ranks as ranks
from molly_tpu.inference.engine import _generate_from_embeds
from molly_tpu.models import fusion as jfusion
from molly_tpu.models import lora as jlora
from molly_tpu.models import qwen3 as jqwen3
from molly_tpu.models import tiny_esm, tiny_moe, tiny_qwen3
from molly_tpu.inference.engine import GenerationConfig
from molly_tpu.models.fusion import FusionConfig
from molly_tpu.parallel import sharding as jsharding
from molly_tpu_torch.models.configs import GenerationConfig as TGen
from molly_tpu_torch.parallel import sharding
from molly_tpu_torch.parallel.launch import run_ranks
from test_torch_models import _tcfg_of

LOSS_RTOL = 2e-5                 # test_sharding.py's loss tolerance
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-5  # test_moe.py's sharded-grad tolerance


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _small_fusion():
    return FusionConfig(
        text=tiny_qwen3(vocab_size=64, hidden_size=32, intermediate_size=64,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, head_dim=8),
        dna_rna=tiny_esm(vocab_size=16), protein=tiny_esm(vocab_size=20),
        dna_rna_k_tokens=4, protein_k_tokens=4)


def _batch(B=4, S=16):
    rng = np.random.default_rng(1)
    labels = np.full((B, S), -100, np.int32)
    labels[:, 10:] = rng.integers(1, 64, (B, S - 10))
    mask = np.ones((B, S), np.int32)
    mask[3, :3] = 0  # left padding
    return {
        "input_ids": rng.integers(0, 64, (B, S)).astype(np.int32),
        "attention_mask": mask, "labels": labels,
        "dna_rna_tokens": rng.integers(2, 16, (B, 1, 4)).astype(np.int32),
        "dna_rna_pos": np.array([[1], [2], [-1], [4]], np.int32),
        "protein_tokens": np.full((B, 1, 4), 1, np.int32),
        "protein_pos": np.full((B, 1), -1, np.int32),
    }


# ------------------------------------------------------------------ rules


def _trees():
    """Every tree kind the rules cover: fusion, bare text, QLoRA {w_q,
    scale}, MoE stacks, int8 and fused expert stacks, LoRA (dense and
    expert-stacked)."""
    cfg = _small_fusion()
    fp = jfusion.init_params(cfg, jax.random.key(0))
    moe = tiny_moe()
    mp = jqwen3.init_params(moe, jax.random.key(1))
    lcfg = jlora.LoraConfig(r=2)
    out = {
        "fusion": fp,
        "bare": fp["text"],
        "qlora": {**fp, "text": jqwen3.quantize_for_training(fp["text"],
                                                             cfg.text),
                  "lora": jlora.init_lora(cfg.text, lcfg,
                                          jax.random.key(2))},
        "moe": {"text": mp, "lora": jlora.init_lora(moe, lcfg,
                                                    jax.random.key(3))},
        "moe_bare": mp,
        "moe_qlora": {"text": jqwen3.quantize_for_training(mp, moe)},
        "moe_int8_fused": {"text": jqwen3.quantize_for_decode(
            mp, moe, moe_experts=True)},
        "moe_fused": {"text": jqwen3.fuse_for_decode(mp, moe)},
    }
    return out


@pytest.mark.parametrize("kind", ["fusion", "bare", "qlora", "moe",
                                  "moe_bare", "moe_qlora", "moe_int8_fused",
                                  "moe_fused"])
def test_param_specs_equal_jax_leaf_for_leaf(kind):
    tree = _trees()[kind]
    bare = kind in ("bare", "moe_bare")
    jspecs = _flat(jsharding.param_specs(tree, bare_text=bare))
    tspecs = _flat(sharding.param_specs(_np_tree(tree), bare_text=bare))
    assert set(jspecs) == set(tspecs)
    for path, js in jspecs.items():
        assert tspecs[path] == tuple(js), path
    if kind == "moe":
        assert tspecs["text/layers/expert_gate"] == (None, "expert", "fsdp",
                                                     "tensor")


@pytest.mark.parametrize("seq_shard", [False, True])
def test_batch_specs_equal_jax(seq_shard):
    batch = {k: np.zeros(v.shape) for k, v in _batch().items()}
    batch["task_label"] = np.zeros((4,))
    js = jsharding.batch_specs(batch, seq_shard=seq_shard)
    ts = sharding.batch_specs(batch, seq_shard=seq_shard)
    assert {k: tuple(v) for k, v in js.items()} == ts


def test_spec_for_path_rules():
    for path in ("text/embed", "text/layers/q_proj", "text/layers/o_proj",
                 "text/layers/input_norm", "dna_rna/layers/ffn_in",
                 "protein_projector/kernel", "lora/layers/q_proj/a",
                 "lora/layers/expert_up/b", "text/layers/expert_down/scale",
                 "no/such/leaf"):
        assert sharding.spec_for_path(path) == tuple(
            jsharding.spec_for_path(path)), path


@pytest.mark.parametrize("kw", [
    dict(data=2, fsdp=2, tensor=2), dict(data=1, tensor=2),
    dict(data=1, fsdp=2, tensor=2, seq=2), dict(data=1, fsdp=2, expert=4),
    dict(data=1, fsdp=4, dcn_data=2), dict(dcn_data=2),
    dict(data=2, seq=2, expert=2)])
def test_make_mesh_maps_ranks_like_jax_device_ids(kw):
    jm = jsharding.make_mesh(**kw)
    tm = sharding.make_mesh(**kw, devices=list(range(8)))
    assert tm.shape == dict(jm.shape)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    np.testing.assert_array_equal(tm.devices, ids)


@pytest.mark.parametrize("n,pi,pc", [(10, 0, 4), (10, 3, 4), (10, 0, 1),
                                     (17, 2, 3)])
def test_host_shard_range_equal(n, pi, pc):
    assert sharding.host_shard_range(n, pi, pc) == \
        jsharding.host_shard_range(n, pi, pc)


def test_block_and_gather_round_trip():
    mesh = sharding.make_mesh(fsdp=2, tensor=2, devices=[0, 1, 2, 3])
    x = np.arange(4 * 6 * 8, dtype=np.float32).reshape(4, 6, 8)
    import torch
    for r, coords in ((0, (0, 0)), (3, (1, 1)), (1, (0, 1))):
        mesh.coords = dict(zip(mesh.axis_names, (0,) + coords + (0, 0)))
        b = sharding.block(torch.from_numpy(x), (None, "fsdp", "tensor"),
                           mesh)
        f, t = coords
        np.testing.assert_array_equal(
            b.numpy(), x[:, f * 3:(f + 1) * 3, t * 4:(t + 1) * 4])


# ------------------------------------------------- sharded loss and decode


def _qlora_params(cfg, params):
    """The fusion params with an r=2 adapter whose b is non-zero (so a has
    a gradient)."""
    ad = jlora.init_lora(cfg.text, jlora.LoraConfig(r=2), jax.random.key(5))
    rng = np.random.default_rng(6)
    ad = {"layers": {t: {"a": np.asarray(ab["a"]),
                         "b": (0.1 * rng.normal(size=ab["b"].shape))
                         .astype(np.float32)}
                     for t, ab in ad["layers"].items()}}
    return {**params, "lora": ad}


@pytest.fixture(scope="module")
def sharded():
    """The JAX references and ONE 4-rank spawn running every port case."""
    cfg = _small_fusion()
    params = jfusion.init_params(cfg, jax.random.key(0))
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        return jfusion.loss_fn(p, cfg, jb)[0]

    ref_loss, ref_grads = jax.value_and_grad(loss)(params)
    qp = _qlora_params(cfg, _np_tree(params))
    qtext = jqwen3.quantize_for_training(params["text"], cfg.text)
    # the port multiplies the activations as given by the int8 weights; the
    # JAX package's CPU int8 path rounds them to bf16 first, so the exact
    # reference is JAX's LoRA over the DEQUANTIZED base (as in
    # test_torch_training.py's QLoRA regime)
    dense = {**qtext, "layers": {
        k: (v["w_q"].astype(jnp.float32) * v["scale"][:, None, :]
            if isinstance(v, dict) else v)
        for k, v in qtext["layers"].items()}}

    def qloss(train):
        p = {**qp, "text": dense, **train}
        embeds = jfusion.build_inputs_embeds(p, cfg, jb)
        hidden, _ = jqwen3.forward_hidden(
            p["text"], cfg.text, inputs_embeds=embeds,
            attention_mask=jb["attention_mask"], lora=p["lora"],
            lora_scale=2.0)
        return jfusion.loss_from_hidden(p, cfg, hidden, jb)[0]

    qtrain = {k: qp[k] for k in ("lora", "dna_rna_projector",
                                 "protein_projector")}
    q_loss, q_grads = jax.value_and_grad(qloss)(qtrain)
    qp = {**qp, "text": _np_tree(qtext)}  # the ranks take JAX's int8 base

    # decode: the JAX test's model and requests
    dcfg = tiny_qwen3(num_hidden_layers=2, vocab_size=256, hidden_size=64,
                      intermediate_size=128, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=16)
    dparams = jqwen3.init_params(dcfg, jax.random.key(0))
    ids = jnp.asarray(np.random.default_rng(0).integers(2, 256, (2, 10)),
                      jnp.int32)
    embeds = jqwen3.embed_tokens(dparams, ids)
    mask = jnp.ones((2, 10), jnp.int32)
    gen = GenerationConfig(max_new_tokens=6, do_sample=False,
                           repetition_penalty=1.1, eos_token_id=-1,
                           pad_token_id=0)
    ref_tokens = np.asarray(_generate_from_embeds(
        dparams, dcfg, embeds, mask, gen, jax.random.key(1)))

    tcfg = _tcfg_of(cfg)
    cases = [("fsdp2_tensor2", dict(fsdp=2, tensor=2), "full"),
             ("tensor4", dict(fsdp=1, tensor=4), "full"),
             ("dcn2_fsdp2", dict(fsdp=2, dcn_data=2), "full"),
             ("qlora_fsdp2_tensor2", dict(fsdp=2, tensor=2), "qlora")]
    tgen = TGen(**dataclasses.asdict(gen))
    full = [c for c in cases if c[2] == "full"]
    qlora = [c for c in cases if c[2] == "qlora"]
    meshes = [("fsdp2_tensor2", dict(fsdp=2, tensor=2)),
              ("tensor4", dict(fsdp=1, tensor=4))]
    got = run_ranks(ranks.many, 4, ([
        ("sharded_loss_and_grads", (tcfg, _np_tree(params), batch, full)),
        ("sharded_loss_and_grads", (tcfg, qp, batch, qlora)),
        ("sharded_decode", (_tcfg_of(dcfg), _np_tree(dparams),
                            np.asarray(embeds), np.asarray(mask), tgen,
                            meshes))],))
    got = [{**a, **b, "decode": c} for a, b, c in got]
    return {"loss": float(ref_loss), "grads": _flat(_np_tree(ref_grads)),
            "q_loss": float(q_loss), "q_grads": _flat(_np_tree(q_grads)),
            "tokens": ref_tokens, "got": got}


@pytest.mark.parametrize("case", ["fsdp2_tensor2", "tensor4", "dcn2_fsdp2"])
def test_sharded_loss_and_grads_match_jax_unsharded(sharded, case):
    for rank_out in sharded["got"]:
        metrics, grads = rank_out[case]
        np.testing.assert_allclose(metrics["loss"], sharded["loss"],
                                   rtol=LOSS_RTOL)
        assert set(grads) == set(sharded["grads"])
        for path, ref in sharded["grads"].items():
            np.testing.assert_allclose(grads[path], ref, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=path)


def test_sharded_qlora_grads_match_jax_unsharded(sharded):
    for rank_out in sharded["got"]:
        metrics, grads = rank_out["qlora_fsdp2_tensor2"]
        np.testing.assert_allclose(metrics["loss"], sharded["q_loss"],
                                   rtol=LOSS_RTOL)
        assert set(grads) == set(sharded["q_grads"])
        for path, ref in sharded["q_grads"].items():
            np.testing.assert_allclose(grads[path], ref, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=path)


@pytest.mark.parametrize("mesh", ["fsdp2_tensor2", "tensor4"])
def test_sharded_greedy_decode_is_token_exact(sharded, mesh):
    for rank_out in sharded["got"]:
        np.testing.assert_array_equal(rank_out["decode"][mesh],
                                      sharded["tokens"])
