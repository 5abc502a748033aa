"""The ``@hot_path`` marker.

A zero-cost decorator naming the functions that run inside the serving
hot path: the verify-round loop and everything it calls per round. The
marker carries no runtime behaviour; it tells the AST linter
(:mod:`repro_torch.analysis.lint`) where device-to-host syncs
(``.item()``, ``.tolist()``, ``.cpu()``, ``int()`` / ``float()`` /
``bool()`` on a tensor, ``nonzero``) are forbidden, without the linter
having to solve whole-program reachability: decorate the roots, and the
linter closes over same-module callees and ``self.<method>`` calls by
itself.

The roots are ``engine/spec_decode.py:verify_round``,
``core/reparam.py:reparam_argmax`` and the engine's ``_round_loop`` and
``_staged_loop``. The marker itself imports nothing.
"""
from __future__ import annotations


def hot_path(fn):
    """Mark ``fn`` as serving-hot-path code for the static linter."""
    fn.__repro_hot_path__ = True
    return fn


def is_hot_path(fn) -> bool:
    return bool(getattr(fn, "__repro_hot_path__", False))
