"""Sequence parallelism over the VAE's token axis (counterpart of
``ladiff_tpu/parallel/sp.py``).

The LA-VAE's encoder runs ``2 * MAX_IT`` distribution tokens and T frame
tokens (206 at HumanML3D's T = 196) through its skip stack, its decoder T
frame queries.  Under ``TRAIN.SEQUENCE_PARALLEL = n`` the token axis is
split over the mesh's ``model`` dim, which stands for ``seq``: each rank
runs LayerNorm, the FFN and the skip GEMMs on its block of the tokens, and
each self-attention all-gathers its keys and values (``ops/sp_hook.py``).
A token count that does not divide (206 over 4) is padded with masked keys.
Stage ``vae`` only, as in the JAX package: the denoiser's few latent tokens
have nothing to split.

The JAX package pins the residual stream to the sequence sharding between
blocks and lets GSPMD insert the collectives; here they are explicit and
differentiable.  Every module takes its plain route in the scope
(``plain_routes``, the JAX package's ``no_pallas()``): attention with local
queries and gathered keys is no kernel's shape.  Gradients: each rank's
parameter gradient is the group size times the single-device one, on every
rank alike (``ops/sp_hook.py``), so the data-parallel mean over all ranks
that the training step takes (``DistributedDataParallel`` over the world)
is the single-device gradient.
"""
from __future__ import annotations

import contextlib

from ladiff_torch.ops.cuda_common import plain_routes
from ladiff_torch.ops.sp_hook import seq_sharding

__all__ = ["SEQ_AXIS", "sequence_parallel", "sp_vae_reconstruct"]

SEQ_AXIS = "seq"


@contextlib.contextmanager
def sequence_parallel(group):
    """The scope of a sequence-parallel forward over ``group``: the token
    axis split (``seq_sharding``) and every module on its plain route."""
    with seq_sharding(group), plain_routes():
        yield


def sp_vae_reconstruct(vae, features, lengths, eps, *, group):
    """The VAE's reconstruction (encode, sample with ``eps`` [B, n_lat, D],
    decode) with the token axis split over ``group``; returns (feats, z,
    mu, logvar, latent_valid) on every rank, equal to the single-device
    ``encode`` / ``decode`` in eval mode (the JAX function's
    ``deterministic=True``).  Differentiable: the parameters' gradients,
    averaged over ``group``, are the single-device ones."""
    with sequence_parallel(group):
        z, mu, logvar, lat_valid = vae.encode(features, lengths, eps=eps)
        feats = vae.decode(z, lengths, features.shape[1])
    return feats, z, mu, logvar, lat_valid
