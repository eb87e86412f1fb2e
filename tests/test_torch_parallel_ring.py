"""``molly_tpu_torch.parallel.ring_attention`` held against
``molly_tpu.parallel.ring_attention`` (``tests/test_ring_attention.py``):
``ring_attention_sharded`` plain and zigzag, causal and not, with the
gradients of q, k and v, on a seq axis of 4 (the JAX side on its virtual
mesh, the port's in 4 gloo ranks, one spawn), the zigzag helpers, and the
one-rank path. fp32; the JAX tests' tolerances."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_ranks as ranks
from molly_tpu.parallel import make_mesh, ring_attention_sharded
# the packages export the function under the module's name
jring = importlib.import_module("molly_tpu.parallel.ring_attention")
tring = importlib.import_module("molly_tpu_torch.parallel.ring_attention")
from molly_tpu_torch.parallel.launch import run_ranks

VALUE_TOL = 2e-5   # test_ring_attention.py's value tolerance
GRAD_TOL = 5e-5    # and its gradient tolerance


def _qkv(B=2, S=32, Nq=4, Nkv=2, D=8, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, Nq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Nkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Nkv, D)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[0, S - 5:] = 0  # right padding on row 0
    mask[1, :3] = 0      # left padding on row 1
    return q, k, v, mask


CASES = {f"{'causal' if c else 'full'}_{'zigzag' if z else 'plain'}":
         (c, z) for c in (True, False) for z in (False, True)}


def _jax_ref(q, k, v, mask, causal, zigzag):
    sel = jnp.asarray(mask, jnp.float32)[..., None, None]

    def loss(q, k, v):
        o = ring_attention_sharded(q, k, v, jnp.asarray(mask),
                                   causal=causal, zigzag=zigzag)
        return jnp.sum(jnp.sin(o) * sel), o

    mesh = make_mesh(data=1, fsdp=1, tensor=1, seq=4,
                     devices=jax.devices()[:4])
    with jax.sharding.set_mesh(mesh):
        (_, o), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                               has_aux=True))(q, k, v)
    return np.asarray(o), [np.asarray(x) for x in g]


@pytest.fixture(scope="module")
def ring():
    q, k, v, mask = _qkv()
    cases = {name: {"q": q, "k": k, "v": v, "mask": mask, "causal": c,
                    "zigzag": z} for name, (c, z) in CASES.items()}
    got = run_ranks(ranks.ring_cases, 4, (cases,))
    refs = {name: _jax_ref(q, k, v, mask, c, z)
            for name, (c, z) in CASES.items()}
    return got, refs, mask.astype(bool)


@pytest.mark.parametrize("name", list(CASES))
def test_ring_attention_sharded_values_match_jax(ring, name):
    got, refs, rows = ring
    for rank_out in got:
        # fully padded query rows differ by design (zeros vs a mean);
        # compare the rows that have a key, as the JAX test does
        np.testing.assert_allclose(rank_out[name]["out"][rows],
                                   refs[name][0][rows], rtol=VALUE_TOL,
                                   atol=VALUE_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_ring_attention_sharded_grads_match_jax(ring, name):
    got, refs, _ = ring
    for rank_out in got:
        for key, ref in zip(("dq", "dk", "dv"), refs[name][1]):
            np.testing.assert_allclose(rank_out[name][key], ref,
                                       rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=key)


@pytest.mark.parametrize("S,n", [(16, 2), (32, 4), (24, 3)])
def test_zigzag_helpers_equal_jax(S, n):
    np.testing.assert_array_equal(tring.zigzag_order(S, n).numpy(),
                                  np.asarray(jring.zigzag_order(S, n)))
    x = np.arange(2 * S * 3, dtype=np.float32).reshape(2, S, 3)
    perm = tring.zigzag_permute(torch.from_numpy(x), n)
    np.testing.assert_array_equal(perm.numpy(),
                                  np.asarray(jring.zigzag_permute(x, n)))
    np.testing.assert_array_equal(
        tring.zigzag_unpermute(perm, n).numpy(), x)


@pytest.mark.parametrize("causal", [True, False])
def test_one_rank_ring_is_plain_attention(causal):
    """Without a seq axis the ring is one chunk: the JAX ring on one
    device."""
    q, k, v, mask = _qkv(seed=3)
    got = tring.ring_attention_sharded(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(mask),
        causal=causal)
    mesh = make_mesh(data=1, fsdp=1, seq=1, devices=jax.devices()[:1])
    with jax.sharding.set_mesh(mesh):
        ref = jax.jit(lambda q, k, v, m: ring_attention_sharded(
            q, k, v, m, causal=causal))(q, k, v, mask)
    rows = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(ref)[rows],
                               rtol=VALUE_TOL, atol=VALUE_TOL)
