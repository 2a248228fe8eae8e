"""The port's DistilBERT text encoder against the JAX package on the CPU:
the tower on converted weights (padded keys under the additive
``finfo(float32).min`` bias); ``HashWordTokenizer`` ids, and
``WordPieceTokenizer`` against the JAX one on a small ``vocab.txt`` in
``tmp_path``; ``BertTextEncoder`` at DistilBERT's real geometry from an
HF-named ``pytorch_model.bin`` that the port writes and both packages load
(the JAX package's own loader, ``load_torch_distilbert_state``, gives back
the converted params bit for bit, which ties the port's names to HF's,
and the port's loader the same),
padded rows zero; and the full-context pairing: a small LADiff system whose
``text_encoded_dim`` is the encoder's width generates from its token
features as the JAX package does.  No ``transformers`` import.

Sizes: the tower at width 32, 2 layers, 4 heads, 9 tokens; the encoder at
768 / 6 layers over 32 hash tokens; the system at d 64, 3 layers, DDIM-3.
Tolerances (PERF.md section 2): forwards 1e-4 norm-wise, ``generate``
2e-3; token ids exact.
"""
import copy

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladiff_torch.convert import distilbert_state_dict
from ladiff_torch.models import bert_text as port
from ladiff_tpu.models import bert_text as ref
from torch_alt_helpers import (TOL, jitted, loaded, noise_tree, relerr,
                               shapes, t)

CAPTIONS = ["A person walks forward, then turns left.",
            "someone jumps high", "the man's arm waves: up-and-down twice!"]
GEN_TOL = 2e-3
SMALL = dict(vocab_size=120, max_position=20, dim=32, n_layers=2,
             n_heads=4, hidden_dim=64)


def test_tower_matches_jax():
    jt = ref.DistilBertTower(**SMALL)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 120, (3, 9)).astype(np.int32)
    mask = np.arange(9)[None] < np.array([9, 5, 2])[:, None]
    params = noise_tree(shapes(jt, ids, mask), 1)["params"]
    want = jitted(jt)({"params": params}, ids, mask)
    tower = loaded(port.DistilBertTower(device="cpu", **SMALL),
                   distilbert_state_dict(params))
    with torch.no_grad():
        got = tower(torch.from_numpy(ids.astype(np.int64)),
                    torch.from_numpy(mask))
    assert got.shape == (3, 9, 32)
    assert relerr(got.numpy(), want) <= TOL
    # valid rows do not depend on what padded tokens hold
    ids2 = ids.copy()
    ids2[2, 2:] = 7
    with torch.no_grad():
        again = tower(torch.from_numpy(ids2.astype(np.int64)),
                      torch.from_numpy(mask))
    assert relerr(again[2, :2].numpy(), got[2, :2].numpy()) <= 1e-6


def test_hash_tokenizer_ids_match_jax():
    ids, mask = port.HashWordTokenizer()(CAPTIONS)
    ids_j, mask_j = ref.HashWordTokenizer()(CAPTIONS)
    np.testing.assert_array_equal(ids, ids_j)
    np.testing.assert_array_equal(mask, mask_j)
    assert ids.shape == (3, 32)


def test_wordpiece_tokenizer_matches_jax(tmp_path):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "person", "walk",
             "##s", "forward", ",", "then", "turn", "##s", "left", ".",
             "some", "##one", "jump", "the", "man", "'", "s", "arm", "wave",
             "up", "-", "and", "down", "twice", "!", ":"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n")
    for max_len in (6, 64):
        got = port.WordPieceTokenizer(str(path), max_len=max_len)(CAPTIONS)
        want = ref.WordPieceTokenizer(str(path), max_len=max_len)(CAPTIONS)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    ids = got[0]
    assert ids.shape == (3, 17)
    assert (ids[:, 0] == 2).all() and 1 in ids  # [CLS], and [UNK] for "high"


@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    """The port's encoder (seeded random tower) saved HF-named (as a task
    model's ``distilbert.`` keys), and the JAX package's encoder loaded
    from it with the port's projection."""
    path = tmp_path_factory.mktemp("distilbert_ckpt")
    ours = port.BertTextEncoder(device="cpu", seed=2)
    torch.save({f"distilbert.{k}": v
                for k, v in ours.tower.state_dict().items()},
               path / "pytorch_model.bin")
    theirs = ref.BertTextEncoder(str(path))
    proj = ours.projection_1
    theirs.proj_params = {"projection_1": {
        "kernel": jnp.asarray(proj.weight.detach().numpy().T),
        "bias": jnp.asarray(proj.bias.detach().numpy())}}
    return path, ours, theirs


def test_both_loaders_read_the_port_names(encoders):
    """``load_torch_distilbert_state`` on the port's checkpoint gives back
    the port's weights under the JAX names, and the port's
    ``load_distilbert_state`` the same state dict, bit for bit."""
    path, ours, theirs = encoders
    want = ours.tower.state_dict()
    for back in (distilbert_state_dict(theirs.params),
                 port.load_distilbert_state(str(path))):
        assert set(back) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(back[k].numpy(), v.numpy(),
                                          err_msg=k)


def test_bert_text_encoder_matches_jax(encoders):
    """[B, 32, 256] projected features, padded rows exactly zero; the
    hidden state and its mask."""
    _, ours, theirs = encoders
    got = ours(CAPTIONS)
    want = np.asarray(theirs(CAPTIONS))
    assert got.shape == want.shape == (3, 32, 256)
    assert relerr(got.numpy(), want) <= TOL
    _, mask = ours.tokenizer(CAPTIONS)
    assert not got[torch.from_numpy(~mask)].any()
    hidden, hmask = ours.last_hidden_state(CAPTIONS)
    hidden_j, hmask_j = theirs.last_hidden_state(CAPTIONS)
    np.testing.assert_array_equal(hmask.numpy(), np.asarray(hmask_j))
    assert relerr(hidden.numpy(), np.asarray(hidden_j)) <= TOL


def test_full_context_generate_matches_jax(encoders):
    """The full-context pairing at a small width: the encoder with a
    64-wide projection, its [B, 32, 64] token features into a LADiff system
    of width 64 with ``text_encoded_dim`` 64 (the denoiser takes them as
    they are, as the published width 256 takes the 256-wide features), CFG
    7.5 DDIM-3, the initial latents passed in; the unconditioned rows are
    the empty caption's."""
    from ladiff_torch.convert import system_state_dict
    from ladiff_torch.models.ladiff import LADiffSystem as TorchSystem
    from ladiff_tpu.models.ladiff import LADiffSystem as JaxSystem
    D = 64
    ours = copy.copy(encoders[1])
    with torch.random.fork_rng():
        torch.manual_seed(6)
        ours.projection_1 = torch.nn.Linear(768, D)
    cond, uncond = ours(CAPTIONS), ours([""] * 3)
    kw = dict(nfeats=263, njoints=22, max_frames=64, latent_dim=(7, D),
              ff_size=128, num_layers=3, num_heads=4, text_encoded_dim=D,
              guidance_scale=7.5, num_inference_timesteps=3)
    jsys = JaxSystem(dropout=0.0, **kw)
    key = jax.random.PRNGKey(11)
    params = noise_tree(jax.eval_shape(jsys.init_params, key), 1)
    tsys = TorchSystem(device="cpu", **kw)
    tsys.load_state_dict(system_state_dict(params), strict=True)
    tsys.eval()
    lengths = np.array([64, 40, 17], np.int32)
    feats_j, z_j = jax.jit(functools.partial(jsys.generate, nframes=64))(
        params, jnp.asarray(cond.numpy()), jnp.asarray(uncond.numpy()),
        jnp.asarray(lengths), key)
    init = jax.random.normal(jax.random.split(key)[0], (3, 5, D),
                             jnp.float32)
    with torch.no_grad():
        feats_t, z_t = tsys.generate(
            cond, uncond, torch.from_numpy(lengths.astype(np.int64)),
            nframes=64, init_latents=t(init))
    assert "denoiser.emb_proj.1.weight" not in tsys.state_dict()
    assert feats_t.shape == (3, 64, 263)
    assert relerr(z_t.numpy(), z_j) <= GEN_TOL
    assert relerr(feats_t.numpy(), feats_j) <= GEN_TOL
