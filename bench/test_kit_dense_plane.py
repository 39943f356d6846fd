"""A second decode kit, here to show that the runner (``bench/decode.py``)
takes any family, batch and plane mode a kit takes: a dense decoder at the
dense kit's smoke widths, two sequences decoded together through the
dense KV plane (``shape_kind`` ``decode``), judged against a plain float32
forward over each sequence's seeded context and the tokens it was fed.
It is reached through the configuration's ``kit`` key alone, and its tests
run it through ``bench.run.measure`` on the CPU.

Each sequence's context is seeded keys and values (``lm_inputs``, one
stream a layer and sequence) written into its frames; the reference reads
none of the program's state: it makes the weights and the context again
and runs the fed tokens through every layer, causally, after the
context.  Numbers compared: ``logits_max_gap``, the widest gap between a
checked step's logits and the reference's over their RMS, every
sequence; ``append_max_gap``, the widest gap between a row the program
appended (any layer, sequence and fed position) and the reference's k/v
there, over the row set's largest entry.
"""
from __future__ import annotations

import contextlib
import copy
import math
import time

import pytest
import torch
from repro_torch.core import kvplane
from repro_torch.models import api
from repro_torch.models import mlp as mlp_lib

from bench import decode, lm_counts, lm_dense, lm_inputs, lm_reference
from bench import run as bench_run

FAMILIES = ("dense",)
MODES = ("dense",)
# bf16 at 2 layers of d 64: sound runs on 12 seeds read logits gaps of
# 0.028-0.057 and appended rows of 0.0068-0.010; with one appended row
# perturbed by 1, on 3 seeds, 0.25-0.32 and 0.31-0.39
LIMITS = {"logits_max_gap": 0.1, "append_max_gap": 0.05}
STEP_PARTS = ((api, "_attn_qkv", "bench.qkv"),
              (kvplane, "append_dense", "bench.append"),
              (kvplane, "attend_dense", "bench.attend"),
              (mlp_lib, "mlp", "bench.mlp"),
              (api, "_logits", "bench.logits"))
SMOKE = {"config": {}, "traffic": {}, "program": [], "limits": LIMITS}

_YI = bench_run.load_json(bench_run.BENCH / "configs" / "yi-9b-200k.json")
CONFIG = {"name": "dense-plane", "system": "lm_decode",
          "kit": "test_kit_dense_plane",
          "model": dict(_YI["model"], **lm_dense.SMOKE["config"]["model"])}
TRAFFIC = {"loop": "closed", "batch": 2, "shape_kind": "decode",
           "greedy": True, "capacity_tokens": 1024, "context_tokens": 192,
           "warm_steps": 4,
           "context": {"key_std": 0.1, "value_std": 1.0, "magnet_share": 0.25,
                       "magnet_norm": 16.0}}
CELL = "dense-plane.pair"
SEED = 2**31 + 7


def _context(m, ctx, pages, P, seed, layer, b, B, device):
    """Sequence ``b``'s context in layer ``layer``: k, v [KVH, pages, P,
    hd] in the served dtype."""
    return lm_inputs.context_layer(m, ctx, pages, P, seed, layer * B + b,
                                   device)


class Kit:
    """The dense plane's side of a decode run."""

    def __init__(self, run):
        self.run = run
        self.dims = lm_inputs.dims(run.cfg["model"])
        self.context = int(run.mix["context_tokens"])
        if self.context % run.kvc.page_tokens or \
                self.context + 1 >= run.shape.seq_len:
            raise ValueError("the context fills whole pages, short of the "
                             "plane's capacity")

    def params(self) -> dict:
        return lm_dense.dense_params(self.dims, self.run.seed,
                                     self.run.device)

    def fill(self, state) -> int:
        run, kvc = self.run, self.run.kvc
        P, NP, B = kvc.page_tokens, kvc.num_pages, run.batch
        n = self.context // P
        for layer, s in enumerate(state.kv):
            for b in range(B):
                k, v = _context(self.dims, run.mix["context"], n, P, run.seed,
                                layer, b, B, run.device)
                s.k_frames[:, b * NP:b * NP + n].copy_(k)
                s.v_frames[:, b * NP:b * NP + n].copy_(v)
        state.lengths.fill_(self.context)
        return self.context

    def first_tokens(self) -> torch.Tensor:
        g = lm_inputs.generator(self.run.seed, lm_inputs.TOKEN, 0,
                                self.run.device)
        return torch.randint(0, self.dims["vocab"], (self.run.batch,),
                             device=self.run.device, generator=g)

    def after_warm(self, state) -> dict:
        return {"lengths": state.lengths.tolist()}

    def describe(self) -> str:
        return (f"{self.context} tokens of context in each of "
                f"{self.run.batch} sequences' dense planes "
                f"({self.run.kvc.num_pages} pages each; lengths after "
                f"warm-up {self.run.after_warm['lengths']})")

    def recording(self, rec: dict):
        return contextlib.nullcontext()

    def keep(self, state, last: int) -> tuple:
        """Each layer's appended rows, positions ``context .. last``:
        k, v [B, KVH, n, hd]."""
        kvc = self.run.kvc
        P, NP = kvc.page_tokens, kvc.num_pages
        pos = torch.arange(self.context, last + 1, device=self.run.device)
        frames = (torch.arange(self.run.batch, device=pos.device)[:, None]
                  * NP + pos // P)
        slot = (pos % P).expand_as(frames)
        return ([s.k_frames[:, frames, slot].transpose(0, 1).clone()
                 for s in state.kv],
                [s.v_frames[:, frames, slot].transpose(0, 1).clone()
                 for s in state.kv])

    def judge(self, steps: list, kept: tuple, fed: list) -> dict:
        with lm_reference.exact_f32(), torch.no_grad():
            return self._judge(steps, kept, fed)

    def _judge(self, steps, kept, fed) -> dict:
        m, run = self.dims, self.run
        dev, B, C = run.device, run.batch, self.context
        P = run.kvc.page_tokens
        app_k, app_v = kept
        n = app_k[0].shape[2]
        tokens = torch.stack(fed[:n]).to(torch.int64)          # [n, B]
        pos = C + torch.arange(n, device=dev)
        head = lm_inputs.embed_and_head(m, run.seed, dev)
        x = head["embed"][tokens.T].float() * math.sqrt(m["d"])  # [B, n, d]
        KVH, G, hd = m["KVH"], m["H"] // m["KVH"], m["hd"]
        mask = torch.arange(C + n, device=dev)[None] > pos[:, None]
        per_step = [dict.fromkeys(LIMITS, 0.0) for _ in steps]
        append = 0.0
        for layer in range(m["L"]):
            w = {k: v.float() for k, v in
                 lm_inputs.layer_weights(m, run.seed, layer, dev).items()}
            for b in range(B):
                ck, cv = _context(m, run.mix["context"], C // P, P, run.seed,
                                  layer, b, B, dev)
                a = lm_reference.rms_norm(x[b], w["ln1"], m["eps"])
                q = lm_reference.rope((a @ w["wq"]).view(n, m["H"], hd), pos,
                                      m["theta"])
                k = lm_reference.rope((a @ w["wk"]).view(n, KVH, hd), pos,
                                      m["theta"]).transpose(0, 1)
                v = (a @ w["wv"]).view(n, KVH, hd).transpose(0, 1)
                gap_k = (app_k[layer][b].float() - k).abs().amax(dim=(0, 2))
                gap_v = (app_v[layer][b].float() - v).abs().amax(dim=(0, 2))
                row_gap = torch.maximum(gap_k / k.abs().max(),
                                        gap_v / v.abs().max())     # [n]
                append = max(append, float(row_gap.max()))
                for i, st in enumerate(steps):
                    per_step[i]["append_max_gap"] = max(
                        per_step[i]["append_max_gap"],
                        float(row_gap[st["t"] - C]))
                keys = torch.cat([ck.reshape(KVH, C, hd).float(), k], dim=1)
                vals = torch.cat([cv.reshape(KVH, C, hd).float(), v], dim=1)
                qg = q.view(n, KVH, G, hd).permute(1, 2, 0, 3)
                s = torch.einsum("kgnd,krd->kgnr", qg, keys) / math.sqrt(hd)
                s = s.masked_fill(mask, -torch.inf)
                o = torch.einsum("kgnr,krd->kgnd", torch.softmax(s, -1), vals)
                o = o.permute(2, 0, 1, 3).reshape(n, m["H"] * hd)
                xb = x[b] + o @ w["wo"]
                a = lm_reference.rms_norm(xb, w["ln2"], m["eps"])
                h = (torch.nn.functional.silu(a @ w["mlp_wg"])
                     * (a @ w["mlp_wi"]))
                x[b] = xb + h @ w["mlp_wo"]
        a = lm_reference.rms_norm(x, head["final_ln"].float(), m["eps"])
        logits = a @ head["lm_head"].float()                     # [B, n, vp]
        for i, st in enumerate(steps):
            want = logits[:, st["t"] - C]
            per_step[i]["logits_max_gap"] = max(
                lm_reference.rel_gap(st["logits"][b], want[b],
                                     want[b].pow(2).mean().sqrt())
                for b in range(B))
        program = {"logits_max_gap": max(s["logits_max_gap"]
                                         for s in per_step),
                   "append_max_gap": append}
        self.readings = {"program": program, "per_step": per_step,
                         "rows": n}
        return self.readings

    def describe_checked(self) -> str:
        return (f"(the start and the window's last {decode.CHECKED}, "
                f"{self.run.batch} sequences; appended rows of "
                f"{self.readings['rows']} steps); per step "
                f"{self.readings['per_step']}")

    def counts(self) -> dict:
        """A step attends every row of every sequence: the last checked
        step's, in every layer."""
        r, run = self.readings, self.run
        rows = run.batch * (self.context + r["rows"]) * self.dims["L"]
        c = lm_counts.StepCounts(attended_rows=rows, fetched_pages=0,
                                 summary_pages=0,
                                 page_tokens=run.kvc.page_tokens,
                                 batch=run.batch)
        return {"flops_per_step": lm_counts.step_flops(run.cfg["model"], c),
                "bytes_per_step": lm_counts.step_bytes(run.cfg["model"], c)}


# -- the tests ----------------------------------------------------------------

@pytest.fixture
def spec(monkeypatch):
    """The benchmark's spec with this kit's cell, and the cell's files."""
    s = copy.deepcopy(bench_run.load_json(bench_run.ROOT / "BENCHMARK.json"))
    s["workloads"].append({"name": CELL, "config": CONFIG["name"],
                           "traffic": "pair", "chips": 1})
    for m in s["end_to_end"]:
        if m["name"] == "decode_tokens_per_s":
            m["workloads"].append(CELL)
    files = bench_run.cell_files

    def with_cell(spec_, name):
        if name == CELL:
            cell = next(w for w in spec_["workloads"] if w["name"] == name)
            return cell, copy.deepcopy(CONFIG), copy.deepcopy(TRAFFIC)
        return files(spec_, name)
    monkeypatch.setattr(bench_run, "cell_files", with_cell)
    return s


def _measure(spec, seed=SEED, seconds=0.5, trace=False):
    return bench_run.measure(spec, CELL, seed, seconds, trace, "cpu",
                             time.time(), log=lambda *a: None)


def test_kit_is_reached_through_the_configuration():
    assert decode.kit_of(CONFIG).__name__ == __name__
    run = decode.Run(CONFIG, TRAFFIC, SEED, 0.0, False, "cpu")
    assert run.mode == "dense" and run.kvc.batch == 2
    assert isinstance(run.kit, Kit)


def test_two_sequences_through_the_dense_plane(spec):
    result, run = _measure(spec)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(LIMITS)
    assert result["failed"] == 0
    assert set(result["metrics"]) == {"decode_tokens_per_s", "setup_s"}
    assert result["metrics"]["decode_tokens_per_s"]["value"] == \
        pytest.approx(2 * run.steps / run.window_s)
    assert run.after_warm["lengths"] == [192 + TRAFFIC["warm_steps"]] * 2
    # the two sequences decode different tokens from different contexts
    assert not torch.equal(run.fed[-1][0], run.fed[-1][1]) or \
        not torch.equal(run.fed[1][0], run.fed[1][1])


def test_traced_run_has_its_spans(spec):
    result, run = _measure(spec, seconds=0.8, trace=True)
    assert result["correct"], result["checks"]
    assert run.segment is not None
    assert "window_s" in result["device"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sound_runs_read_within_the_limits(spec, seed):
    result, _ = _measure(spec, seed=seed, seconds=0.3)
    assert result["correct"], result["checks"]


def _one_row_perturbed(orig):
    """Sequence 1's v row at the second fed position appended off by 1."""
    def inner(cfg, s, k_new, v_new, lengths):
        hit = (lengths == TRAFFIC["context_tokens"] + 1)
        hit[0] = False
        return orig(cfg, s, k_new, v_new + hit[:, None, None].to(v_new.dtype),
                    lengths)
    return inner


def test_one_appended_row_perturbed_is_not_correct(spec, monkeypatch):
    monkeypatch.setattr(kvplane, "append_dense",
                        _one_row_perturbed(kvplane.append_dense))
    result, _ = _measure(spec)
    assert not result["correct"], result["checks"]
    assert result["checks"]["append_max_gap"]["value"] > \
        LIMITS["append_max_gap"]


def test_control_needs_a_kit_that_has_one(spec):
    """``bench.lm_control`` runs a kit's control and faults only where the
    kit has them; this one has neither."""
    from bench import lm_control
    with pytest.raises(ValueError, match="has no control"):
        lm_control.readings(spec, CELL, SEED, 0.1, "cpu", control=True)
    with pytest.raises(ValueError, match="has no fault"):
        lm_control.readings(spec, CELL, SEED, 0.1, "cpu", control=False,
                            fault="altered")
