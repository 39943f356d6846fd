"""The plain reference of a dense decoder's decode step through the sparse
KV plane, and the comparison that decides ``correct`` for a decode cell.

Plain ``torch`` in float32 with TF32 off.  It imports nothing of the
program: its weights and each layer's context are made again from the
seed by ``bench/lm_inputs.py``, with the calls the dense kit
(``bench/lm_dense.py``) made them with.
A step is, per layer: RMSNorm, the q/k/v projections, RoPE at the
absolute position, then the sparse plane's stated semantics:

* the page summaries (each page's elementwise max and min key) recomputed
  from the page's rows, and a page's Quest score ``max over heads of
  sum_d max(q_d * kmax_d, q_d * kmin_d)``;
* the top ``topk_pages`` of the valid pages by score, lowest index first
  among ties, invalid pages never, the append page forced into the last
  slot when it is not among them;
* the pages local after the step's fetch: those resident before it, and
  the first ``fetch_budget`` missing ones in rank order, as many as the
  frames that no resident selected page holds allow;
* exact GQA attention over the rows each local page holds: the whole page
  up to the current token (the paging path), or, for a page on the
  runtime path with hot rows marked, those rows (packed);

then the output projection, RMSNorm, SwiGLU and, after the last layer,
the final norm and the head.  The new token's k/v are the reference's own.

What the reference takes from the program's run, and why.  The outputs it
judges: the logits of each checked step, the token each step was fed (the
greedy argmax of the step before) and, per layer, the page selection, the
rows attended with the frames' contents, and the profiling the step left:
each page's card bits, PSF and hot rows after it.  Beyond them, two things
only the program's history settles: (1) which pages were resident before
the step and each page's card bits, path and hot rows then (copied before
the step's fetch); (2) the k/v rows that the steps before the checked one
appended (positions from the context's end), read from the program's slab
after the window; (3) the query each layer scored the pages with, so the
scoring and the top-K are judged apart from the bf16 residual stream's
drift (the query comes from the same normed input as the appended k/v,
and the logits judge the stream).  The rest it works out again.  The stages these skip are
judged by themselves, on every checked step: the profiling by its stated
rules (a row attended is marked in its page's cards where its attention
weight, under some query head, is above the page's mean; a page put out
keeps PSF = card access rate >= ``car_threshold`` and, as hot rows, its
cards mapped back to the page's rows; nothing else changes), and the
appended rows at every layer; layer 0's appended rows, which depend on the
fed token alone, for every step from set-up on.  The start, the first step
after the context, is checked against the initial plane, with no program
state.  The selection the program made, once judged, is the one the
reference attends over (a boundary page whose score ties within rounding
would otherwise flip between the two precisions).  Not judged: which
frame a fetch evicts (the coldest by the frames' clocks), which decides
only which pages stay local, not what a local page holds; and the deeper
layers' rows appended by unchecked steps, whose reference would be the
whole window again.

Numbers compared (``LIMITS``; PERF.md gives the readings they were set
from): ``logits_max_gap``, the widest gap between the program's logits
and the reference's over the head's rows, over the reference's RMS;
``selection_gap``, the widest amount by which a page the program left
out scores above one it selected (append page aside), over the top
score, each page's score worked out by the reference from the page's
rows and the query the program scored with (so the residual stream's
rounding, which the logits judge, does not blur the scoring's);
``selection_mismatch``, the program's selection entries
against the rules (the append page missing, an invalid or repeated page,
a count other than ``min(valid pages, topk)``); ``rows_mismatch``,
attended rows that are not the reference's (a page attended that is not
local or the reverse, a row count off, a row whose k or v differ from the
row of that position); ``append_max_gap``, the widest gap between an
appended k/v row and the reference's own, over the row set's largest
entry; ``marks_max_gap``, over the card bits that differ from the rule,
how far the reference's weight of that row lies from its page's mean on
the other side (``1 - r`` for a row marked at ``r`` times the mean,
``1 - 1/r`` for one left unmarked; 1 for a bit set or cleared that no
rule touches); ``pageout_mismatch``, PSF and hot-row bits that differ
from the page-out rule.

The control (``precision="fp8"``): the same reference with every matmul
and score input rounded to float8 e4m3 (per-tensor scale), one precision
below the served bfloat16, put in the program's place.
"""
from __future__ import annotations

import contextlib
import math

import torch

from . import lm_inputs

LIMITS = {"logits_max_gap": 0.45, "selection_gap": 0.001,
          "selection_mismatch": 0,
          "rows_mismatch": 0, "append_max_gap": 0.12,
          "marks_max_gap": 0.25, "pageout_mismatch": 0}


@contextlib.contextmanager
def exact_f32():
    """Float32 matrix products in float32 (TF32 off) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale over the tensor (its
    largest entry at 448), back in float32."""
    s = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def rms_norm(x, gamma, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * gamma


def rope(x, pos, theta):
    """x [n, heads, hd] at positions ``pos`` [n]: the halves rotated."""
    half = x.shape[-1] // 2
    ar = torch.arange(half, dtype=torch.float32, device=x.device)
    freq = torch.pow(torch.full((), theta, dtype=torch.float32,
                                device=x.device), -ar / half)
    ang = pos[:, None].to(torch.float32) * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _mark_gap(marked, r):
    """How far weights ``r`` (over the page's mean) lie on the other side
    of the mean from marks ``marked``: ``1 - 1/r`` for a row left unmarked
    above it, ``1 - r`` for one marked below it, 0 where they agree."""
    above = r > 1
    return torch.where(marked == above, 0.0,
                       torch.where(above, 1 - 1 / r.clamp_min(1), 1 - r))


def rel_gap(got: torch.Tensor, want: torch.Tensor, scale) -> float:
    return float((got.float() - want.float()).abs().max() / scale)


class _Layer:
    """One layer's inputs, made once and shared by every pass: weights in
    float32 (and rounded, for a control), the context rows and their
    summaries, the appended rows the program wrote."""

    def __init__(self, ref, layer: int, app_k, app_v):
        m, dev = ref.m, ref.device
        w = lm_inputs.layer_weights(m, ref.seed, layer, dev)
        self.w = {k: v.float() for k, v in w.items()}
        self.w8 = ({k: fp8(v) if v.dim() == 2 else v
                    for k, v in self.w.items()} if ref.control else None)
        k, v = lm_inputs.context_layer(m, ref.ctx, ref.ctx_pages, ref.P,
                                       ref.seed, layer, dev)
        KVH, hd = m["KVH"], m["hd"]
        kf = k.float()
        self.kmax = kf.amax(dim=2)                     # [KVH, NPc, hd]
        self.kmin = kf.amin(dim=2)
        del kf
        # every row a position < the last appended one holds: [KVH, T, hd]
        self.k = torch.cat([k.reshape(KVH, -1, hd),
                            app_k.reshape(KVH, -1, hd)], dim=1)
        self.v = torch.cat([v.reshape(KVH, -1, hd),
                            app_v.reshape(KVH, -1, hd)], dim=1)


class Pass:
    """One step of the reference (or of the control), layer by layer."""

    def __init__(self, step: dict, precision: str, select: str,
                 follow: "Pass | None" = None):
        self.step, self.t = step, int(step["t"])
        self.lo = fp8 if precision == "fp8" else _same
        self.precision = precision
        self.select = select            # "own" | "program" | "follow"
        self.follow = follow
        self.layers = []                # per layer: what it chose and made


class Reference:
    """The reference over a cell's checked steps.  ``model``: the
    configuration's ``model`` block; ``plane``: its page size, top-K,
    local frames and fetch budget; ``ctx``: the traffic's context block."""

    def __init__(self, model: dict, plane: dict, ctx: dict, seed: int,
                 context_tokens: int, device, control: bool = False):
        self.m = lm_inputs.dims(model)
        self.P = int(plane["page_tokens"])
        self.K = int(plane["topk_pages"])
        self.F = int(plane["local_frames"])
        self.budget = int(plane["fetch_budget"])
        self.thr = float(plane["car_threshold"])
        self.ctx, self.seed = ctx, int(seed)
        self.C = int(context_tokens)
        if self.C % self.P:
            raise ValueError("the context must fill whole pages")
        self.ctx_pages = self.C // self.P
        self.device = torch.device(device)
        self.control = control

    # -- the pieces of a step ------------------------------------------------

    def _proj(self, p: Pass, L: _Layer, x):
        m, lo = self.m, p.lo
        w = L.w8 if p.precision == "fp8" else L.w
        a = rms_norm(x, w["ln1"], m["eps"])
        a8 = lo(a)
        pos = torch.tensor([p.t], device=self.device)
        q = rope((a8 @ w["wq"]).view(1, m["H"], m["hd"]), pos, m["theta"])[0]
        k = rope((a8 @ w["wk"]).view(1, m["KVH"], m["hd"]), pos,
                 m["theta"])[0]
        v = (a8 @ w["wv"]).view(m["KVH"], m["hd"])
        return q, k, v

    def _scores(self, p: Pass, L: _Layer, q, k):
        """Each valid page's score [n_valid] (pages up to the current
        token's), from summaries of the rows this pass knows."""
        m, P, t = self.m, self.P, p.t
        KVH, G, hd = m["KVH"], m["H"] // m["KVH"], m["hd"]
        n_valid = t // P + 1
        napp = n_valid - self.ctx_pages
        rows = torch.full((KVH, napp * P, hd), math.nan,
                          device=self.device)
        rows[:, :t - self.C] = L.k[:, self.C:t].float()
        rows[:, t - self.C] = k
        rows = rows.view(KVH, napp, P, hd)
        fin = ~torch.isnan(rows)
        kmax = torch.cat([L.kmax, torch.where(fin, rows, -torch.inf)
                          .amax(dim=2)], dim=1)
        kmin = torch.cat([L.kmin, torch.where(fin, rows, torch.inf)
                          .amin(dim=2)], dim=1)
        qg = p.lo(q).view(KVH, G, 1, hd)
        s = torch.maximum(qg * kmax[:, None], qg * kmin[:, None]).sum(-1)
        return s.amax(dim=1).amax(dim=0)               # [n_valid]

    def _top(self, scores, newest: int) -> torch.Tensor:
        """The top-K selection by the stated rules, [K] (-1 pad)."""
        K = self.K
        order = torch.sort(scores, descending=True, stable=True).indices
        top = torch.full((K,), -1, dtype=torch.int64, device=self.device)
        n = min(K, scores.shape[0])
        top[:n] = order[:n]
        if not bool((top == newest).any()):
            top[K - 1] = newest
        return top

    def _initial(self, rec: dict) -> dict:
        """The plane before the start: nothing resident, every page on the
        paging path, no card bits or hot rows (shapes as ``rec``'s)."""
        return {"pt": torch.full_like(rec["pt"], -1),
                "psf": torch.ones_like(rec["psf"]),
                "hint": torch.zeros_like(rec["hint"]),
                "cat": torch.zeros_like(rec["cat"]),
                "prow": torch.zeros_like(rec["prow"])}

    def _local(self, p: Pass, sel, before: dict) -> tuple:
        """The local pages of selection ``sel`` [K] after the fetch: for
        each entry its positions (None if not local), and how many pages
        the fetch brought in.  ``before``: the page table, PSF and hints
        before the step."""
        P, t = self.P, p.t
        valid = sel >= 0
        safe = sel.clamp_min(0)
        res = valid & (before["pt"][safe] >= 0)
        psf, hint = before["psf"][safe], before["hint"][safe]
        missing = valid & ~res
        pinned = int(torch.unique(sel[res]).numel())
        room = max(0, min(self.budget, self.F - pinned))
        rank = torch.cumsum(missing.long(), 0) - 1
        fetched = missing & (rank < room)
        local = res | fetched
        packed = (~psf & hint.any(dim=1)).tolist()
        out = []
        for j, (pg, loc) in enumerate(zip(sel.tolist(), local.tolist())):
            if not loc:
                out.append(None)
            elif packed[j]:
                out.append(pg * P + hint[j].nonzero().flatten())
            else:
                fill = min(P, t + 1 - pg * P)
                out.append(pg * P + torch.arange(fill, device=self.device))
        return out, int(fetched.sum())

    def _attend(self, p: Pass, L: _Layer, q, k, v, positions):
        """The attention output [H * hd], and for each local page of
        ``positions`` its rows' weights over the page's mean [n] (the
        largest under any query head; None where not local)."""
        m, lo = self.m, p.lo
        KVH, G, hd = m["KVH"], m["H"] // m["KVH"], m["hd"]
        local = [x for x in positions if x is not None]
        if not local:
            return torch.zeros(m["H"] * hd, device=self.device), positions
        pos = torch.cat(local)
        own = pos == p.t
        idx = torch.where(own, 0, pos)
        kr = torch.where(own[None, :, None], k[:, None],
                         L.k[:, idx].float())             # [KVH, R, hd]
        vr = torch.where(own[None, :, None], v[:, None], L.v[:, idx].float())
        qg = lo(q).view(KVH, G, hd)
        s = torch.einsum("kgd,krd->kgr", qg, lo(kr)) / math.sqrt(hd)
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("kgr,krd->kgd", w, lo(vr))
        counts = torch.tensor([x.numel() for x in local], device=self.device)
        seg = torch.repeat_interleave(
            torch.arange(len(local), device=self.device), counts)
        mass = torch.zeros(KVH, G, len(local), device=self.device)
        mass.index_add_(2, seg, w)
        r = torch.where(mass[..., seg] > 0, self.P * w / mass[..., seg], 0.0)
        r = iter(r.amax(dim=(0, 1)).split(counts.tolist()))
        return (o.reshape(m["H"] * hd),
                [None if x is None else next(r) for x in positions])

    def _mlp_and_out(self, p: Pass, L: _Layer, x, o):
        m, lo = self.m, p.lo
        w = L.w8 if p.precision == "fp8" else L.w
        x = x + lo(o) @ w["wo"]
        a = lo(rms_norm(x, w["ln2"], m["eps"]))
        h = torch.nn.functional.silu(a @ w["mlp_wg"]) * (a @ w["mlp_wi"])
        return x + lo(h) @ w["mlp_wo"]

    # -- the run -------------------------------------------------------------

    def run(self, steps: list, app_k: list, app_v: list, fed) -> dict:
        """Every checked step (``steps``: dicts with ``t``, ``token``,
        ``logits``, ``start`` and per-layer records ``layers``), and with
        ``control`` the control in the program's place; then layer 0's
        appended rows for every fed token (``fed`` [n], from position
        ``context_tokens`` on).  Returns the readings."""
        with exact_f32(), torch.no_grad():
            return self._run(steps, app_k, app_v, fed)

    def _run(self, steps, app_k, app_v, fed) -> dict:
        m, dev = self.m, self.device
        head = lm_inputs.embed_and_head(m, self.seed, dev)
        emb = head["embed"]
        passes = []
        for st in steps:
            ref = Pass(st, "f32", "program")
            passes.append(ref)
            if self.control:
                ctl = Pass(st, "fp8", "own")
                passes += [ctl, Pass(st, "f32", "follow", follow=ctl)]
        x = {id(p): emb[p.step["token"]].float() * math.sqrt(m["d"])
             for p in passes}
        per_step = [dict.fromkeys(LIMITS, 0.0) for _ in steps]
        ctl_read = {"selection_gap": [], "append_max_gap": [],
                    "marks_max_gap": []}
        counts = {"attended_rows": [0] * len(steps),
                  "fetched_pages": [0] * len(steps)}
        layer0 = None
        for layer in range(m["L"]):
            L = _Layer(self, layer, app_k[layer], app_v[layer])
            if layer == 0:
                layer0 = self._layer0(L, emb, fed)
            for p in passes:
                i = steps.index(p.step)
                rec = p.step["layers"][layer]
                before = self._initial(rec) if p.step["start"] else rec
                q, k, v = self._proj(p, L, x[id(p)])
                newest = p.t // self.P
                if p.select == "program":
                    sel = rec["tops"].to(torch.int64)
                elif p.select == "follow":
                    sel = p.follow.layers[layer]["sel"]
                else:
                    sel = self._top(self._scores(p, L, q, k), newest)
                positions, n_fetched = self._local(p, sel, before)
                o, ratios = self._attend(p, L, q, k, v, positions)
                p.layers.append({"sel": sel, "q": q, "k": k, "v": v,
                                 "ratios": ratios})
                if p.select == "program":
                    gap, bad = self._judge_selection(
                        sel, self._scores(p, L, rec["q"], k), newest)
                    per_step[i]["selection_gap"] = max(
                        per_step[i]["selection_gap"], gap)
                    per_step[i]["selection_mismatch"] += bad
                    per_step[i]["rows_mismatch"] += self._judge_rows(
                        rec, positions, L, p.t)
                    per_step[i]["append_max_gap"] = max(
                        per_step[i]["append_max_gap"],
                        self._append_gap(L, p.t, k, v))
                    per_step[i]["marks_max_gap"] = max(
                        per_step[i]["marks_max_gap"],
                        self._judge_marks(rec, before, sel, positions,
                                          ratios))
                    per_step[i]["pageout_mismatch"] += self._judge_pageout(
                        rec, before)
                    counts["attended_rows"][i] += sum(
                        x_.numel() for x_ in positions if x_ is not None)
                    counts["fetched_pages"][i] += n_fetched
                elif p.select == "follow":
                    c = p.follow.layers[layer]
                    gap, _ = self._judge_selection(
                        c["sel"], self._scores(p, L, c["q"], k), newest)
                    ctl_read["selection_gap"].append(gap)
                    ctl_read["append_max_gap"].append(max(
                        rel_gap(c["k"], k, k.abs().max()),
                        rel_gap(c["v"], v, v.abs().max())))
                    ctl_read["marks_max_gap"].append(max(
                        [_mark_gap(a > 1, b).max().item()
                         for a, b in zip(c["ratios"], ratios)
                         if a is not None] or [0.0]))
                x[id(p)] = self._mlp_and_out(p, L, x[id(p)], o)
            del L
        logits = {}
        for p in passes:
            w = head["lm_head"].float()
            a = rms_norm(x[id(p)], head["final_ln"].float(), m["eps"])
            logits[id(p)] = p.lo(a) @ (fp8(w) if p.precision == "fp8"
                                       else w)
        for i, st in enumerate(steps):
            ref = next(p for p in passes if p.step is st
                       and p.select == "program")
            r = logits[id(ref)]
            per_step[i]["logits_max_gap"] = rel_gap(
                st["logits"], r, r.pow(2).mean().sqrt())
        out = dict.fromkeys(LIMITS, 0.0)
        for s in per_step:
            for k in out:
                out[k] = max(out[k], s[k]) if "gap" in k else out[k] + s[k]
        out["append_max_gap"] = max(out["append_max_gap"],
                                    layer0["program"])
        result = {"program": out, "per_step": per_step,
                  **counts, "layer0_rows": layer0["rows"]}
        if self.control:
            gaps = []
            for p in passes:
                if p.select == "follow":
                    r = logits[id(p)]
                    gaps.append(rel_gap(logits[id(p.follow)], r,
                                        r.pow(2).mean().sqrt()))
            result["control"] = {
                "logits_max_gap": max(gaps),
                "selection_gap": max(ctl_read["selection_gap"]),
                "selection_mismatch": 0, "rows_mismatch": 0,
                "append_max_gap": max(max(ctl_read["append_max_gap"]),
                                      layer0["control"]),
                "marks_max_gap": max(ctl_read["marks_max_gap"]),
                "pageout_mismatch": 0}
        return result

    # -- the judgements ------------------------------------------------------

    def _judge_selection(self, sel, scores, newest: int) -> tuple:
        """(gap, rule breaks) of selection ``sel`` against the scores."""
        n_valid = scores.shape[0]
        valid = sel >= 0
        pages = sel[valid]
        bad = int((pages >= n_valid).sum()) + int((sel < -1).sum())
        bad += abs(int(valid.sum()) - min(n_valid, self.K))
        bad += int(pages.numel() - torch.unique(pages).numel())
        bad += int(not bool((pages == newest).any()))
        chosen = torch.zeros(n_valid, dtype=torch.bool, device=self.device)
        chosen[pages[pages < n_valid]] = True
        chosen[newest] = False
        left = torch.ones_like(chosen)
        left[pages[pages < n_valid]] = False
        left[newest] = False
        gap = 0.0
        if chosen.any() and left.any():
            gap = float((scores[left].max() - scores[chosen].min())
                        .clamp_min(0) / scores.abs().max())
        return gap, bad

    def _judge_rows(self, rec, positions, L: _Layer, t: int) -> int:
        """Rows the program attended that are not the reference's."""
        table, rows = rec["table"].tolist(), rec["rows"].tolist()
        bad = 0
        for j, want in enumerate(positions):
            here = table[j] >= 0
            n_got = rows[j] if here else 0
            n_want = 0 if want is None else want.numel()
            if here != (want is not None):
                bad += max(n_got, n_want)
                continue
            if not here:
                continue
            n = min(n_got, n_want)
            bad += abs(n_got - n_want)
            if n:
                pos = want[:n]
                kk, vv = L.k[:, pos], L.v[:, pos]          # [KVH, n, hd]
                gk, gv = rec["kf"][:, j, :n], rec["vf"][:, j, :n]
                diff = ((gk != kk) | (gv != vv)).flatten(2).any(2).any(0)
                bad += int(diff.sum())
        return bad

    def _judge_marks(self, rec, before, sel, positions, ratios) -> float:
        """The card bits after the step against the profiling rule:
        ``marks_max_gap`` (0 where every bit is the rule's).  A page
        fetched or put out starts from no bits; a local page gains the
        rows weighted above its mean; a selection entry that is not local
        writes page 0's bits back as they were (the program's stated
        semantics: of duplicate writes the last wins), so page 0's gains
        stand only where no such entry follows it; nothing else moves."""
        NP, P = rec["cat"].shape[0] - 1, self.P
        cat_b, got = before["cat"][:NP], rec["cat_after"][:NP]
        moved = (before["pt"][:NP] >= 0) != (rec["pt_after"][:NP] >= 0)
        want = cat_b & ~moved[:, None]
        gap = torch.ones((NP, P), device=self.device)
        gone = [x is None for x in positions]
        for j, (pg, r) in enumerate(zip(sel.tolist(), ratios)):
            if r is None or (pg == 0 and any(gone[j + 1:])):
                continue
            n, prior = r.numel(), want[pg, :r.numel()]
            unmarked = torch.zeros_like(prior)
            gap[pg, :n] = torch.where(
                r > 1, _mark_gap(unmarked, r),
                torch.where(prior, 1.0, _mark_gap(~unmarked, r)))
            want[pg, :n] = prior | (r > 1)
        wrong = got != want
        return float(gap[wrong].max()) if bool(wrong.any()) else 0.0

    def _judge_pageout(self, rec, before) -> int:
        """PSF and hot-row bits after the step that break the page-out
        rule: a page put out (resident before, not after) takes PSF =
        (card bits set / page size >= ``car_threshold``) and as hot rows
        its card bits, mapped back through its hot rows where it was held
        packed (slot i of a packed page is its i-th hot row); every other
        page keeps both."""
        NP, P = rec["cat"].shape[0] - 1, self.P
        want_psf = before["psf"][:NP].clone()
        want_hint = before["hint"][:NP].clone()
        out = (before["pt"][:NP] >= 0) & (rec["pt_after"][:NP] < 0)
        for pg in out.nonzero().flatten().tolist():
            cards = before["cat"][pg]
            want_psf[pg] = int(cards.sum()) / P >= self.thr
            if int(before["prow"][pg]) >= P:
                want_hint[pg] = cards
            else:
                hot = before["hint"][pg].nonzero().flatten()
                want_hint[pg] = False
                want_hint[pg, hot] = cards[:hot.numel()]
        return int((rec["psf_after"][:NP] != want_psf).sum()
                   + (rec["hint_after"][:NP] != want_hint).sum())

    def _append_gap(self, L: _Layer, t: int, k, v) -> float:
        """The program's row at position ``t`` against this step's own."""
        return max(rel_gap(L.k[:, t], k, k.abs().max()),
                   rel_gap(L.v[:, t], v, v.abs().max()))

    def _layer0(self, L: _Layer, emb, fed) -> dict:
        """Layer 0's k/v of every fed token at its position against the
        rows the program appended; with ``control``, the control's too."""
        m = self.m
        n = fed.shape[0]
        pos = self.C + torch.arange(n, device=self.device)
        x = emb[fed].float() * math.sqrt(m["d"])
        out = {"rows": n}
        for name, lo, w in (("program", _same, L.w),
                            ("control", fp8, L.w8)):
            if w is None:
                continue
            a = lo(rms_norm(x, w["ln1"], m["eps"]))
            k = rope((a @ w["wk"]).view(n, m["KVH"], m["hd"]), pos,
                     m["theta"]).transpose(0, 1)
            v = (a @ w["wv"]).view(n, m["KVH"], m["hd"]).transpose(0, 1)
            if name == "program":
                ref_k, ref_v = k, v
                got_k, got_v = L.k[:, pos], L.v[:, pos]
            else:
                got_k, got_v = k, v
            out[name] = max(rel_gap(got_k, ref_k, ref_k.abs().max()),
                            rel_gap(got_v, ref_v, ref_v.abs().max()))
        return out
