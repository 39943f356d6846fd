"""The decode kit of a dense decoder through the sparse KV plane: one long
sequence, batch 1 (``yi-9b-200k.long``).  The kit a configuration gets
without a ``kit`` key.

The weights and each layer's context come from the seed on the device
(``bench/lm_inputs.py``); the context goes into each layer's far tier with
its page summaries, as a prefill would leave it.  A checked step records,
per layer, the selection and the query it was scored with, the plane's
state around the fetch and the profiling, and the rows attended with the
frames' contents; ``bench/lm_reference.py`` judges them, and with the
control (``CONTROL``) reads the reference in float8 in the program's
place.  ``bench/lm_counts.py`` counts a step's operations and bytes from
the rows the checked steps attended and the pages they fetched;
``bench/lm_faults.py`` holds the faults the check must refuse.
"""
from __future__ import annotations

import contextlib

import torch
from repro_torch.core import kvplane
from repro_torch.models import api
from repro_torch.models import mlp as mlp_lib

from . import decode, lm_counts, lm_faults, lm_inputs, lm_reference

FAMILIES = ("dense",)
MODES = ("sparse",)
LIMITS = lm_reference.LIMITS
CONTROL = True
FAULTS = lm_faults.FAULTS

# the step's parts, spanned in the traced segment
STEP_PARTS = ((api, "_attn_qkv", "bench.qkv"),
              (kvplane, "append_sharded", "bench.append"),
              (kvplane, "_select", "bench.select"),
              (kvplane, "fetch_pages", "bench.fetch"),
              (kvplane, "_attend_pages_partial", "bench.attend"),
              (kvplane, "_profile", "bench.profile"),
              (mlp_lib, "mlp", "bench.mlp"),
              (api, "_logits", "bench.logits"))

# the CPU size of the family (2 layers, d 64, 4 heads, 2 KV heads, 1,920
# tokens of context in 64-token pages, top 4 of them, 6 frames, 2 fetched
# a step), and its limits: two layers at d 64 round differently from 48
# at d 4096 (sound runs on 8 seeds here read logits gaps up to 0.048, the
# control 0.31-0.61; appended rows 0.017 against 0.096; selection gaps 0,
# the scoring faults 0.0014-0.92; card marks up to 0.032 against the
# control's 0.04-0.25)
SMOKE = {
    "config": {"model": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                             d_ff=128, vocab=512),
               "plane": {"page_tokens": 64, "topk_pages": 4,
                         "local_frames": 6, "fetch_budget": 2,
                         "car_threshold": 0.8}},
    "traffic": dict(capacity_tokens=4096, context_tokens=1920, warm_steps=6),
    "program": [(api, "SPARSE_TOPK", 4), (api, "SPARSE_LOCAL_FRAMES", 6),
                (api, "FETCH_BUDGET", 2)],
    "limits": {"logits_max_gap": 0.1, "selection_gap": 1e-4,
               "selection_mismatch": 0,
               "rows_mismatch": 0, "append_max_gap": 0.05,
               "marks_max_gap": 0.1, "pageout_mismatch": 0},
}


def dense_params(m: dict, seed: int, device) -> dict:
    """A dense decoder's seeded weights (``lm_inputs``) in the program's
    tree."""
    blocks = []
    for layer in range(m["L"]):
        w = lm_inputs.layer_weights(m, seed, layer, device)
        blocks.append({"ln1": w["ln1"], "ln2": w["ln2"],
                       "attn": {k: w[k] for k in ("wq", "wk", "wv", "wo")},
                       "mlp": {"wi": w["mlp_wi"], "wg": w["mlp_wg"],
                               "wo": w["mlp_wo"]}})
    return dict(lm_inputs.embed_and_head(m, seed, device), blocks=blocks)


class Kit:
    """The sparse plane's side of a decode run: its weights, context,
    recorder, check and counts."""

    def __init__(self, run):
        self.run = run
        self.dims = lm_inputs.dims(run.cfg["model"])
        kvc = run.kvc
        if run.batch != 1:
            raise ValueError("the sparse plane decodes one sequence: a "
                             "closed loop at batch 1")
        plane = run.cfg["plane"]
        have = {"page_tokens": kvc.page_tokens,
                "topk_pages": kvc.sparse_topk,
                "local_frames": kvc.num_frames,
                "fetch_budget": kvc.fetch_budget,
                "car_threshold": kvc.car_threshold}
        if any(plane[k] != v for k, v in have.items()):
            raise ValueError(f"the program's plane is {run.mode} {have}, the "
                             f"configuration states sparse {plane}")
        self.context = int(run.mix["context_tokens"])
        if self.context % kvc.page_tokens or \
                self.context + 1 >= run.shape.seq_len:
            raise ValueError("the context fills whole pages, short of the "
                             "plane's capacity")

    @staticmethod
    def planes(state) -> list:
        return [kv[0] for kv in state.kv]

    # -- set-up -------------------------------------------------------------

    def params(self) -> dict:
        return dense_params(self.dims, self.run.seed, self.run.device)

    def fill(self, state) -> int:
        """Each layer's context into its plane's far tier, with the page
        summaries (``write_page_to_slab``'s, for every page at once)."""
        run = self.run
        P = run.kvc.page_tokens
        n = self.context // P
        for layer, s in enumerate(self.planes(state)):
            k, v = lm_inputs.context_layer(self.dims, run.mix["context"], n,
                                           P, run.seed, layer, run.device)
            s.k_slab[:, :n].copy_(k)
            s.v_slab[:, :n].copy_(v)
            s.kmax[:, :n].copy_(k.amax(dim=2).float())
            s.kmin[:, :n].copy_(k.amin(dim=2).float())
            del k, v
        state.lengths.fill_(self.context)
        return self.context

    def first_tokens(self) -> torch.Tensor:
        return lm_inputs.first_token(self.dims, self.run.seed, self.run.device)

    def after_warm(self, state) -> dict:
        F = self.run.kvc.num_frames
        return {"frames_held": min(int((s.frame_page[:F] >= 0).sum())
                                   for s in self.planes(state))}

    def describe(self) -> str:
        kvc, n = self.run.kvc, self.run.model.n_layers
        return (f"{self.context} tokens of context in each of {n} sparse "
                f"planes ({kvc.num_pages} pages, {kvc.num_frames} frames, "
                f"top-{kvc.sparse_topk}, fetch budget {kvc.fetch_budget}; "
                f"the emptiest layer holds "
                f"{self.run.after_warm['frames_held']} of its frames after "
                f"warm-up)")

    # -- a checked step -------------------------------------------------------

    @contextlib.contextmanager
    def recording(self, rec: dict):
        """Each layer's selection and the query it was scored with; the
        plane's page table, PSF, hints, card bits and page rows before the
        fetch, the table, PSF and hints after it; the rows attended with
        the frames' contents; the card bits after the profiling: appended
        to ``rec["layers"]`` as the step runs."""
        layers = rec["layers"] = []

        def select(orig):
            def inner(cfg, s, q, n_valid, newest):
                top = orig(cfg, s, q, n_valid, newest)
                layers.append({"tops": top[0], "q": q[0].float().clone()})
                return top
            return inner

        def fetch(orig):
            def inner(cfg, s, tops, fills, **kw):
                layer = layers[-1]
                layer.update(pt=s.page_table.clone(), psf=s.psf.clone(),
                             hint=s.hot_hint.clone(), cat=s.cat.clone(),
                             prow=s.page_rows.clone())
                out = orig(cfg, s, tops, fills, **kw)
                layer.update(pt_after=s.page_table.clone(),
                             psf_after=s.psf.clone(),
                             hint_after=s.hot_hint.clone())
                return out
            return inner

        def profile(orig):
            def inner(cfg, s, *a):
                orig(cfg, s, *a)
                layers[-1]["cat_after"] = s.cat.clone()
            return inner

        def attend(orig):
            def inner(q, kf, vf, table, rows):
                at = table[0].clamp_min(0).long()
                layers[-1].update(table=table[0], rows=rows[0],
                                  kf=kf[:, at], vf=vf[:, at])
                return orig(q, kf, vf, table, rows)
            return inner
        with decode.patched(kvplane, "_select", select), \
                decode.patched(kvplane, "fetch_pages", fetch), \
                decode.patched(kvplane, "_attend_pages_partial", attend), \
                decode.patched(kvplane, "_profile", profile):
            yield

    # -- the check ------------------------------------------------------------

    def keep(self, state, last: int) -> tuple:
        """The rows each layer appended, positions ``context .. last``."""
        P = self.run.kvc.page_tokens
        a, b = self.context // P, last // P + 1
        n = last + 1 - self.context
        app_k, app_v = [], []
        for s in self.planes(state):
            KVH, hd = s.k_slab.shape[0], s.k_slab.shape[-1]
            app_k.append(s.k_slab[:, a:b].reshape(KVH, -1, hd)[:, :n].clone())
            app_v.append(s.v_slab[:, a:b].reshape(KVH, -1, hd)[:, :n].clone())
        return app_k, app_v

    def judge(self, steps: list, kept: tuple, fed: list) -> dict:
        run = self.run
        app_k, app_v = kept
        n = app_k[0].shape[1]
        fed = torch.cat(fed[:n]).to(torch.int64)
        steps = [{"t": c["t"], "token": int(c["tok"]),
                  "logits": c["logits"][0], "layers": c["layers"],
                  "start": c["start"]} for c in steps]
        ref = lm_reference.Reference(run.cfg["model"], run.cfg["plane"],
                                     run.mix["context"], run.seed,
                                     self.context, run.device,
                                     control=run.control)
        self.readings = ref.run(steps, app_k, app_v, fed)
        return self.readings

    def describe_checked(self) -> str:
        r = self.readings
        steps = [{k: round(v, 6) for k, v in s.items()} for s in r["per_step"]]
        return (f"(the start and the window's last {decode.CHECKED}; layer "
                f"0's appended rows of {r['layer0_rows']} steps); per step "
                f"{steps}; rows attended {r['attended_rows']} and pages "
                f"fetched {r['fetched_pages']} a step over the layers")

    def counts(self) -> dict:
        """The step's operations and bytes, from the rows the window's
        checked steps attended and the pages they fetched."""
        r, kvc = self.readings, self.run.kvc
        window = range(len(r["per_step"]) - decode.CHECKED,
                       len(r["per_step"]))
        c = lm_counts.StepCounts(
            attended_rows=sum(r["attended_rows"][i] for i in window)
            / decode.CHECKED,
            fetched_pages=sum(r["fetched_pages"][i] for i in window)
            / decode.CHECKED,
            summary_pages=kvc.num_pages, page_tokens=kvc.page_tokens,
            batch=self.run.batch)
        m = self.run.cfg["model"]
        return {"flops_per_step": lm_counts.step_flops(m, c),
                "bytes_per_step": lm_counts.step_bytes(m, c)}
