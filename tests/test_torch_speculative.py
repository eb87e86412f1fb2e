"""The port's speculative decoding (``inference.speculative``) held against
molly_tpu's on the CPU, in fp32, from the same numpy-seeded weights: the
lookup drafter on the same histories; greedy draft-verify (a perfect draft
at k = 1, 3, 4, a disagreeing draft, EOS, repetition penalty, a fusion
prompt, full acceptance) and greedy lookup token-equal to the JAX functions
with the same (n_rounds, n_accepted) and to the port's own engine; sampled
runs held in distribution against the port's engine with the JAX tests'
statistic and threshold (total variation < 0.16 over 600 draws a
position); and the batch CLI's ``--decoding lookup`` JSONL record for
record against the JAX CLI's.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from molly_tpu.inference import speculative as jspec
from molly_tpu.inference.engine import GenerationConfig as JGen
from molly_tpu.models import fusion as jfusion
from molly_tpu.models import qwen3 as jqwen3
from molly_tpu.models import tiny_esm, tiny_qwen3
from molly_tpu.models.fusion import FusionConfig
from molly_tpu_torch.inference import cli, speculative
from molly_tpu_torch.inference.engine import _generate_from_embeds
from molly_tpu_torch.models import fusion, qwen3
from molly_tpu_torch.models.configs import GenerationConfig
from molly_tpu_torch.models.convert import params_from_jax
from test_torch_models import _np_tree, _tcfg_of

V = 128
TV_MAX = 0.16  # the JAX tests' bound at 600 draws


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tensors here are tiny: one intra-op thread, as the suite runs
    several workers side by side (a pool of threads a worker made each
    small op wait on the others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def varied(tree, seed):
    """Unit-scale numpy weights, so that greedy tokens vary (the 0.02 init
    of a tiny model repeats one token)."""
    rng = np.random.default_rng(seed)
    tree["embed"] = rng.normal(size=tree["embed"].shape).astype(np.float32)
    for name, w in tree["layers"].items():
        if w.ndim == 3:
            tree["layers"][name] = (rng.normal(size=w.shape)
                                    * w.shape[1] ** -0.5).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def models():
    cfg = tiny_qwen3(num_hidden_layers=2, vocab_size=V)
    dcfg = tiny_qwen3(num_hidden_layers=1, vocab_size=V, hidden_size=32,
                      intermediate_size=64)
    t = varied(_np_tree(jqwen3.init_params(cfg, jax.random.key(0))), 1)
    d = varied(_np_tree(jqwen3.init_params(dcfg, jax.random.key(9))), 2)
    jt, jd = jax.tree.map(jnp.asarray, t), jax.tree.map(jnp.asarray, d)
    return (cfg, jt, _tcfg_of(cfg), params_from_jax(t),
            dcfg, jd, _tcfg_of(dcfg), params_from_jax(d))


def gens(T, penalty=1.0, eos=-1):
    kw = dict(max_new_tokens=T, do_sample=False, repetition_penalty=penalty,
              eos_token_id=eos, pad_token_id=0)
    return JGen(**kw), GenerationConfig(**kw)


def sample_gens(T):
    kw = dict(max_new_tokens=T, do_sample=True, temperature=0.8, top_p=0.95,
              top_k=10, repetition_penalty=1.1, eos_token_id=-1,
              pad_token_id=0)
    return JGen(**kw), GenerationConfig(**kw)


def prompt(seed, P):
    return np.random.default_rng(seed).integers(2, V, (1, P)).astype(np.int32)


def engine_greedy(tp, tcfg, ids, gen, embeds=None):
    ids_t = torch.as_tensor(ids).long()
    if embeds is None:
        embeds = qwen3.embed_tokens(tp, ids_t)
    return _generate_from_embeds(
        tp, tcfg, embeds, torch.ones(ids.shape, dtype=torch.int32),
        gen).numpy()


def both(jfn, tfn):
    """(JAX tokens, rounds, accepted), (port ...) as numpy / ints."""
    jo, jr, ja = jfn()
    to, tr, ta = tfn()
    return (np.asarray(jo), int(jr), int(ja)), (to.numpy(), tr, ta)


# ------------------------------------------------------------ lookup drafts


def test_lookup_drafts_match_jax():
    """The unit histories of the JAX test (a most recent earlier match; no
    match: the pad slice at L) and random looping histories."""
    cases = [([5, 6, 7, 9, 5, 6, 8, 5, 6, 0, 0, 0], 9, 2, 3),
             ([1, 2, 3, 4, 6, 8, 0, 0, 0, 0, 0, 0], 6, 2, 3)]
    rng = np.random.default_rng(4)
    for _ in range(6):
        h = rng.integers(1, 5, 24)
        cases.append((list(h), int(rng.integers(5, 20)), 3, 4))
    for hist, L, n, k in cases:
        ref = jspec._lookup_drafts(jnp.asarray(hist, jnp.int32),
                                   jnp.int32(L), len(hist), n=n, k=k)
        got = speculative._lookup_drafts(torch.tensor(hist), L, len(hist),
                                         n=n, k=k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got = speculative._lookup_drafts(torch.tensor(cases[0][0]), 9, 12, n=2,
                                     k=3)
    np.testing.assert_array_equal(got.numpy(), [8, 5, 6])


# ------------------------------------------------------------ draft-verify


@pytest.mark.parametrize("case", [
    "perfect_k1", "perfect_k3", "perfect_k4", "other_draft", "eos",
    "penalty_perfect", "penalty_other", "full_accept"])
def test_greedy_speculative_matches_jax_and_engine(models, case):
    cfg, jt, tcfg, tp, dcfg, jd, tdcfg, td = models
    k, T, penalty, other, seed, P = 3, 12, 1.0, False, 1, 9
    if case.startswith("perfect"):
        k = int(case[-1]) if case[-1].isdigit() else 3
        T = 10
    if case == "other_draft":
        other, seed, P = True, 2, 7
    if case.startswith("penalty"):
        penalty, other, seed = 1.1, case.endswith("other"), 11
    if case == "full_accept":
        k, T, penalty, seed, P = 4, 16, 1.1, 12, 6
    ids = prompt(seed, P)
    jg, tg = gens(T, penalty)
    if case == "eos":
        # the 4th free-running token as EOS: generation stops and pads
        free = engine_greedy(tp, tcfg, ids, tg)[0]
        jg, tg = gens(T, penalty, eos=int(free[3]))
        other = True
    jdp, jdc, tdp, tdc = ((jd, dcfg, td, tdcfg) if other
                          else (jt, cfg, tp, tcfg))
    (jo, jr, ja), (to, tr, ta) = both(
        lambda: jspec.generate_speculative(
            jt, cfg, jdp, jdc, jnp.asarray(ids), jg, k=k, return_stats=True),
        lambda: speculative.generate_speculative(
            tp, tcfg, tdp, tdc, torch.as_tensor(ids).long(), tg, k=k,
            return_stats=True))
    np.testing.assert_array_equal(to, jo)
    assert (tr, ta) == (jr, ja)
    np.testing.assert_array_equal(to, engine_greedy(tp, tcfg, ids, tg))
    if not other:  # a perfect draft accepts every draft of every round
        assert ta == k * tr, (ta, tr)
    if case == "eos":
        assert (to[0] == 0).any() and len(set(to[0].tolist())) > 1


def _fusion_case(models):
    cfg, jt, tcfg, tp = models[:4]
    fcfg = FusionConfig(text=cfg, dna_rna=tiny_esm(vocab_size=16),
                        protein=tiny_esm(vocab_size=20),
                        dna_rna_k_tokens=4, protein_k_tokens=4)
    jparams = jfusion.init_params(fcfg, jax.random.key(2))
    jparams["text"] = jt
    tparams = params_from_jax(_np_tree(jparams))
    rng = np.random.default_rng(8)
    S = 12
    batch = {
        "input_ids": rng.integers(2, V, (1, S)).astype(np.int32),
        "dna_rna_tokens": rng.integers(2, 16, (1, 1, 4)).astype(np.int32),
        "dna_rna_pos": np.asarray([[3]], np.int32),
        "protein_tokens": np.full((1, 1, 4), 1, np.int32),
        "protein_pos": np.asarray([[-1]], np.int32),
    }
    jemb = jfusion.build_inputs_embeds(
        jparams, fcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    temb = fusion.build_inputs_embeds(
        tparams, _tcfg_of(fcfg),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), atol=1e-5)
    return batch["input_ids"], jemb, temb


@pytest.mark.parametrize("mode", ["speculative", "lookup"])
def test_fusion_prompt_matches_jax_and_engine(models, mode):
    """Decoding from injected fusion embeddings (ids carried for the lookup
    history) against JAX and the engine on the same embeddings."""
    cfg, jt, tcfg, tp = models[:4]
    ids, jemb, temb = _fusion_case(models)
    jg, tg = gens(8)
    if mode == "speculative":
        (jo, jr, ja), (to, tr, ta) = both(
            lambda: jspec.generate_speculative(
                jt, cfg, jt, cfg, gen=jg, k=3, inputs_embeds=jemb,
                return_stats=True),
            lambda: speculative.generate_speculative(
                tp, tcfg, tp, tcfg, gen=tg, k=3, inputs_embeds=temb,
                return_stats=True))
    else:
        (jo, jr, ja), (to, tr, ta) = both(
            lambda: jspec.generate_lookup(
                jt, cfg, jnp.asarray(ids), gen=jg, k=3, n=2,
                inputs_embeds=jemb, return_stats=True),
            lambda: speculative.generate_lookup(
                tp, tcfg, torch.as_tensor(ids).long(), gen=tg, k=3, n=2,
                inputs_embeds=temb, return_stats=True))
    np.testing.assert_array_equal(to, jo)
    assert (tr, ta) == (jr, ja)
    np.testing.assert_array_equal(to, engine_greedy(tp, tcfg, ids, tg,
                                                    temb))


# ------------------------------------------------------------ prompt lookup


@pytest.mark.parametrize("case", ["periodic", "periodic_penalty", "eos"])
def test_greedy_lookup_matches_jax_and_engine(models, case):
    cfg, jt, tcfg, tp = models[:4]
    if case == "eos":
        ids, k, n = prompt(3, 8), 3, 2
        free = engine_greedy(tp, tcfg, ids, gens(12)[1])[0]
        jg, tg = gens(12, eos=int(free[3]))
    else:
        pat = np.random.default_rng(21).integers(2, V, 4)
        ids = np.concatenate([pat, pat, pat])[None].astype(np.int32)
        k, n = 4, 2
        jg, tg = gens(12, 1.1 if case.endswith("penalty") else 1.0)
    (jo, jr, ja), (to, tr, ta) = both(
        lambda: jspec.generate_lookup(jt, cfg, jnp.asarray(ids), jg, k=k,
                                      n=n, return_stats=True),
        lambda: speculative.generate_lookup(
            tp, tcfg, torch.as_tensor(ids).long(), tg, k=k, n=n,
            return_stats=True))
    np.testing.assert_array_equal(to, jo)
    assert (tr, ta) == (jr, ja)
    np.testing.assert_array_equal(to, engine_greedy(tp, tcfg, ids, tg))


# ------------------------------------------------------------ sampled


def _tv(a, b, pos):
    fa = np.bincount(a[:, pos], minlength=V) / len(a)
    fb = np.bincount(b[:, pos], minlength=V) / len(b)
    return 0.5 * np.abs(fa - fb).sum()


def _engine_samples(tp, tcfg, ids, gen, n, seed):
    """n target-only sampled generations in one batch (rows draw
    independently)."""
    ids_t = torch.as_tensor(np.repeat(ids, n, axis=0)).long()
    return _generate_from_embeds(
        tp, tcfg, qwen3.embed_tokens(tp, ids_t),
        torch.ones(ids_t.shape, dtype=torch.int32), gen,
        torch.Generator().manual_seed(seed)).numpy()


def test_sampled_perfect_draft_accepts_everything(models):
    """With draft == target the acceptance ratio is exactly 1."""
    cfg, jt, tcfg, tp = models[:4]
    _, tg = sample_gens(6)
    _, r, a = speculative.generate_speculative(
        tp, tcfg, tp, tcfg, torch.as_tensor(prompt(5, 8)).long(), tg, k=3,
        generator=torch.Generator().manual_seed(7), return_stats=True)
    assert a == 3 * r, (a, r)


@pytest.mark.parametrize("draft", ["perfect", "other", "lookup"])
def test_sampled_distribution_matches_engine(models, draft):
    """The first two sampled tokens' marginals equal target-only sampling
    (the rejection rule's guarantee): a perfect draft (always accept), a
    disagreeing draft (rejection and residual) and the point-mass lookup
    draft."""
    cfg, jt, tcfg, tp, dcfg, jd, tdcfg, td = models
    _, tg = sample_gens(2)
    ids = prompt(6, 8)
    n = 600
    ref = _engine_samples(tp, tcfg, ids, tg, n, 1000)
    g = torch.Generator().manual_seed(2000)
    ids_t = torch.as_tensor(ids).long()
    if draft == "lookup":
        got = np.stack([speculative.generate_lookup(
            tp, tcfg, ids_t, tg, k=2, n=2, generator=g)[0].numpy()
            for _ in range(n)])
    else:
        dp, dc = (td, tdcfg) if draft == "other" else (tp, tcfg)
        got = np.stack([speculative.generate_speculative(
            tp, tcfg, dp, dc, ids_t, tg, k=2, generator=g)[0].numpy()
            for _ in range(n)])
    for pos in range(2):
        tv = _tv(ref, got, pos)
        assert tv < TV_MAX, (pos, tv)


# ------------------------------------------------------------ CLI


def test_cli_lookup_jsonl_matches_jax_cli(tmp_path, monkeypatch):
    """``--decoding lookup`` through both CLIs (--tiny, greedy, the same
    weights) writes the same records, and the port's equal its own batch
    engine's."""
    from test_torch_serving import _jax_weights
    from test_train_cli import _toy_parquet

    from molly_tpu.inference.cli import main as jax_main

    data = str(tmp_path / "d.parquet")
    _toy_parquet(data, 4)
    common = ["--input-file", data, "--tiny", "--greedy",
              "--max-length", "256", "--max-new-tokens", "6",
              "--dna-rna-k-tokens", "4", "--protein-k-tokens", "4",
              "--batch-size", "2"]
    lookup = ["--decoding", "lookup", "--lookup-k", "3", "--lookup-n", "2"]
    out = {name: str(tmp_path / f"{name}.jsonl")
           for name in ("jax", "port", "engine")}
    jax_main(common + lookup + ["--output-file", out["jax"]])
    monkeypatch.setattr(cli, "_load_params", _jax_weights)
    cli.main(common + lookup + ["--output-file", out["port"], "--device",
                                "cpu"])
    cli.main(common + ["--output-file", out["engine"], "--device", "cpu"])
    recs = {name: [json.loads(line) for line in open(path)]
            for name, path in out.items()}
    assert len(recs["port"]) == 4
    assert recs["port"] == recs["jax"] == recs["engine"]


def test_run_lookup_tokens_equal_run_batches(models):
    """The CLI's lookup loop on encoded, left-padded samples: the same
    tokens as the batch engine's greedy run (the prompt is decoded
    unpadded, omics starts shifted), counted rounds and drafts."""
    import io

    from molly_tpu_torch.data import (DataConfig, OmicsSampleEncoder,
                                      default_modality_tokenizers,
                                      load_text_tokenizer)
    from molly_tpu_torch.models.configs import FusionConfig as TFusion

    text_tok = load_text_tokenizer(None)
    dna_tok, prot_tok = default_modality_tokenizers()
    enc = OmicsSampleEncoder(text_tok, dna_tok, prot_tok, DataConfig(
        max_len=200, dna_rna_k_tokens=4, protein_k_tokens=4))
    vocab = -(-text_tok.vocab_size // 128) * 128
    cfg = tiny_qwen3(vocab_size=vocab, num_hidden_layers=2)
    text = varied(_np_tree(jqwen3.init_params(cfg, jax.random.key(4))), 5)
    fcfg = FusionConfig(
        text=cfg, dna_rna=tiny_esm(vocab_size=dna_tok.vocab_size,
                                   mask_token_id=2),
        protein=tiny_esm(vocab_size=prot_tok.vocab_size,
                         mask_token_id=prot_tok.mask_id),
        dna_rna_k_tokens=4, protein_k_tokens=4)
    tree = _np_tree(jfusion.init_params(fcfg, jax.random.key(1)))
    tree["text"] = text
    params = params_from_jax(tree)
    tcfg = _tcfg_of(fcfg)
    assert isinstance(tcfg, TFusion)
    samples = [enc.encode_test({"input": s}) for s in (
        "Is <dna>ACGTACGTAAC</dna> a promoter? yes yes yes",
        "Soluble? <protein>MKTAYIAKQR</protein> MKTA MKTA")]

    class Ids:  # decode spells the ids, so records compare token for token
        eos_token_id = text_tok.eos_token_id

        def decode(self, ids, skip_special_tokens=True):
            return " ".join(map(str, ids))

    _, gen = gens(10, 1.1, eos=text_tok.eos_token_id)
    stats = {}
    got = cli.run_lookup(samples, params, tcfg, gen, Ids(), io.StringIO(),
                         k=4, n=2, stats=stats)
    ref = cli.run_batches(samples, params, tcfg, gen, Ids(), io.StringIO(),
                          batch_size=2)
    assert [r["decoded_output"] for r in got] == \
        [r["decoded_output"] for r in ref]
    assert stats["rounds"] > 0 and stats["tokens"] > 0
