"""Parallel layouts of the port (counterpart of ``ladiff_tpu/parallel/``),
under ``torchrun`` (``mesh.init_distributed``):

  mesh.py    process group, the 2-D ``("data", "model")`` ``DeviceMesh``,
             the batch rule (pad, take this rank's rows), the global draws'
             rows, data-parallel evaluation, the full state dict
  fsdp.py    ZeRO-3 over the ``data`` dim (FSDP2 ``fully_shard``)
  tp.py      Megatron tensor parallelism over the ``model`` dim
  sp.py      sequence parallelism over the VAE's token axis (the ``model``
             dim standing for ``seq``)
  pp.py      GPipe over the denoiser's MD skip stack
  dryrun.py  one step of every layout a world size admits, spawned on the
             CPU or the card

Data parallelism itself is ``DistributedDataParallel`` over the ``data``
dim, wired in ``training/trainer.py`` (``make_parallel_step``).

Where the port's layouts differ from the JAX package's, and why (the math
is the same in each case, and the tests hold the results, not the layout):

  * DDP and FSDP keep every kernel route.  The JAX package traces its FSDP
    and TP steps under ``no_pallas()`` because the SPMD partitioner cannot
    split a custom call; DDP runs whole layers on every rank, and FSDP2
    unshards a layer's parameters before its forward, so the kernels see
    whole weights.  TP's sharded layers, SP's VAE and PP's pipelined stack
    take the plain routes, as ``no_pallas()`` does: a column-parallel
    shard, local queries against gathered keys, and the pipeline's unfused
    MD layers are no kernel's shape.  The rest of their steps keeps its
    kernels (stage 2's frozen VAE encode), where ``no_pallas()`` covered
    the whole traced step.
  * FSDP2 shards dim 0 of every parameter, padded where it does not
    divide; the JAX rule shards the largest divisible dim and replicates a
    leaf with none (``fsdp.py``).
  * The pipeline's backward is an explicit schedule of point-to-point
    sends in reverse microbatch order, in place of the transpose of
    ``ppermute`` that ``jax.grad`` derives (``pp.py``).
  * The collectives of TP and SP are explicit autograd functions where
    GSPMD inserts them from sharding annotations (``tp.py``,
    ``ops/sp_hook.py``).
"""
