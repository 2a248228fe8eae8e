"""Pipeline-parallel encoder override (counterpart of
``ladiff_tpu/ops/pp_hook.py``).

``parallel/pp.py`` pipelines the denoiser's MD skip stack over a process
group.  To train through that schedule without forking the model code,
``MDSkipTransformerEncoder.forward`` consults this context variable first:
inside a ``pp_encoder_override(fn)`` scope it hands its inputs to ``fn``
instead of running its layer loop.  Lives in ``ops/`` so
``ops/stylization.py`` can import it without a cycle.
"""
from __future__ import annotations

import contextlib
import contextvars

__all__ = ["pp_encoder_override", "pp_override_get"]

# callable(encoder, x, xf, emb, latent_valid) -> tokens, or None
_PP = contextvars.ContextVar("ladiff_pp_override", default=None)


@contextlib.contextmanager
def pp_encoder_override(fn):
    """Within this scope ``MDSkipTransformerEncoder`` delegates its forward
    to ``fn(encoder, x, xf, emb, latent_valid)``."""
    tok = _PP.set(fn)
    try:
        yield
    finally:
        _PP.reset(tok)


def pp_override_get():
    return _PP.get()
