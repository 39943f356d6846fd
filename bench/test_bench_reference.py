"""The reference and the comparison that decides ``correct``."""
import torch

from bench import reference


def _data(n=1000, d=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, d), generator=g)


def test_reference_indexes_the_data():
    data = _data()
    keys = torch.tensor([5, 0, 999, 5, 17], dtype=torch.int32)
    ref = reference.expected(data, keys)
    for i, k in enumerate(keys.tolist()):
        assert torch.equal(ref[i], data[k])


def test_exact_rows_pass():
    data = _data()
    keys = torch.randint(0, 1000, (3000,), dtype=torch.int32)
    served = [(keys[a:a + 1024], data[keys[a:a + 1024].long()].clone())
              for a in range(0, 3000, 1024)]
    got = reference.compare(data, served, block_rows=1500)
    assert got == {"rows": 3000, "rows_wrong": 0, "max_abs_gap": 0.0}


def test_control_in_bfloat16_fails():
    """The reference one precision down is refused by every limit of 0."""
    data = _data()
    keys = torch.arange(1000, dtype=torch.int32)
    got = reference.compare(data, [(keys, reference.control(data, keys))])
    assert got["rows_wrong"] > 990
    assert 1e-4 < got["max_abs_gap"] < 1e-2


def test_one_altered_element_is_caught():
    data = _data()
    keys = torch.arange(1000, dtype=torch.int32)
    rows = data.clone()
    rows[123, 7] = torch.nextafter(rows[123, 7], torch.tensor(2.0))
    got = reference.compare(data, [(keys, rows)])
    assert got["rows_wrong"] == 1 and got["max_abs_gap"] > 0


def test_control_script_is_refused():
    """The control at a size a test holds: every seed reads not correct."""
    import json
    from unittest import mock

    from bench import control
    from bench import run as bench_run

    spec = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")
    load = bench_run.load_json

    def small(path):
        d = load(path)
        if path.parent.name == "configs":
            d.update(objects=4096, warm_ticks=2)
        return d
    with mock.patch.object(bench_run, "load_json", small):
        for w in spec["workloads"]:
            if bench_run.cell_files(spec, w["name"])[1]["system"] \
                    != "kv_store":
                continue
            for seed in (1, 2, 3):
                r = control.readings(spec, w["name"], seed, 20_000, "cpu")
                assert r["rows_wrong"] > 0.99 * r["rows"], json.dumps(r)
                assert r["max_abs_gap"] > 0 and r["readback_wrong"] > 0
