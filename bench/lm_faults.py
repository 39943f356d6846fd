"""Faults planted under a decode cell's timed path, each a wrapper of one
function of the program, to show that the check refuses it: the tests at
a smoke size (``bench/test_bench_decode.py``) and the readings at the
cell's own size (``python3 -m bench.lm_control --faults ...``).

``FAULTS[name]`` is ``(module, attribute, wrap)``, planted by
``bench.decode.patched``, which replaces ``module.attribute`` by
``wrap(original)`` inside a block.  The benchmark's runs plant none.
"""
from __future__ import annotations

import torch
from repro_torch.core import kvplane
from repro_torch.kernels import ops
from repro_torch.models import api

from . import lm_reference


def _newest_dropped(orig):
    """The append page left out of the selection."""
    def inner(cfg, s, q, n_valid, newest):
        top = orig(cfg, s, q, n_valid, newest)
        return torch.where(top == newest[:, None], -1, top)
    return inner


def _random_pages(orig):
    """Valid pages drawn at random in place of the top-K (the append page
    kept last, as the rules ask)."""
    g = {}

    def inner(cfg, s, q, n_valid, newest):
        top = orig(cfg, s, q, n_valid, newest)
        if q.device not in g:
            g[q.device] = torch.Generator(device=q.device).manual_seed(7)
        n, K = int(n_valid[0]), top.shape[1]
        pick = torch.randperm(n - 1, generator=g[q.device],
                              device=q.device)[:K - 1]
        pick = torch.where(pick >= newest[0], pick + 1, pick)
        return torch.cat([pick, newest[:1]])[None].to(top.dtype)
    return inner


def _kmax_only(orig):
    """Page scores from each page's largest keys alone (the smallest
    ignored)."""
    def inner(q, kmax, kmin, **kw):
        return orig(q, kmax, kmax, **kw)
    return inner


def _kv_head_dropped(orig):
    """Page scores with the first KV head's left out."""
    def inner(q, kmax, kmin, **kw):
        out = orig(q, kmax, kmin, **kw).clone()
        out[:, 0] = -torch.inf
        return out
    return inner


def _not_local_attended(orig):
    """Selected pages that the fetch left out taken as local: the page
    table sends them to frame 0, a whole page of rows each."""
    def inner(cfg, s, tops, fills, **kw):
        out = orig(cfg, s, tops, fills, **kw)
        t = tops[0].clamp_min(0).long()
        missing = (tops[0] >= 0) & (s.page_table[t] < 0)
        s.page_table[t[missing]] = 0
        s.page_rows[t[missing]] = cfg.page_tokens
        return out
    return inner


def _wrong_page_fetched(orig):
    """The page fetch copying the next page's rows."""
    def inner(slab, page_ids, perm=None, **kw):
        ids = torch.where(page_ids >= 0, (page_ids + 1) % slab.shape[1],
                          page_ids)
        return orig(slab, ids, perm, **kw)
    return inner


def _marks_shifted(orig):
    """Each attended row's card mark set on the row after it."""
    def inner(q, kf, vf, table, rows):
        acc, m, l, used = orig(q, kf, vf, table, rows)
        return acc, m, l, used.roll(1, dims=-1)
    return inner


def _marks_none(orig):
    """No attended row marked."""
    def inner(q, kf, vf, table, rows):
        acc, m, l, used = orig(q, kf, vf, table, rows)
        return acc, m, l, torch.zeros_like(used)
    return inner


def _psf_flipped(orig):
    """A page put out on the other path than its card access rate gives."""
    def inner(cfg, cat_now, old_hint, old_rows):
        psf, hint = orig(cfg, cat_now, old_hint, old_rows)
        return ~psf, hint
    return inner


def _low_precision_logits(orig):
    """The head's product in float8 e4m3."""
    def inner(cfg, params, x):
        p = dict(params, lm_head=lm_reference.fp8(
            params["lm_head"].float()).to(params["lm_head"].dtype))
        return orig(cfg, p, lm_reference.fp8(x.float()).to(x.dtype))
    return inner


def _altered(orig):
    """One logit altered where it is produced."""
    def inner(cfg, params, x):
        out = orig(cfg, params, x).clone()
        out[:, 7] += 1.0
        return out
    return inner


def _unchanged(orig):
    """A step that returns its state unchanged (no position advanced)."""
    def build(cfg, shape, *a, **kw):
        step = orig(cfg, shape, *a, **kw)

        def inner(params, state, tokens):
            new, logits = step(params, state, tokens)
            return new._replace(lengths=state.lengths), logits
        return inner
    return build


FAULTS = {"newest_dropped": (kvplane, "_select", _newest_dropped),
          "random_pages": (kvplane, "_select", _random_pages),
          "kmax_only": (ops, "page_scores", _kmax_only),
          "kv_head_dropped": (ops, "page_scores", _kv_head_dropped),
          "not_local_attended": (kvplane, "fetch_pages",
                                 _not_local_attended),
          "wrong_page_fetched": (ops, "gather_pages", _wrong_page_fetched),
          "marks_shifted": (kvplane, "_attend_pages_partial",
                            _marks_shifted),
          "marks_none": (kvplane, "_attend_pages_partial", _marks_none),
          "psf_flipped": (kvplane, "_evict_math", _psf_flipped),
          "low_precision_logits": (api, "_logits", _low_precision_logits),
          "altered": (api, "_logits", _altered),
          "unchanged": (api, "decode_step", _unchanged)}

