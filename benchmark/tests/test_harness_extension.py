"""A configuration, a traffic mix, a cell and a per-layer metric are added
to a copy of the benchmark as new files and entries alone, and the new cell
runs (on the CPU, at a tiny width): no file that was there is edited but
BENCHMARK.json, which gains entries."""

import hashlib
import json
import shutil
import subprocess
import sys
import textwrap

from benchmark import core
from benchmark.tests.tiny import tiny

CELL = "encdec-IANv1-tiny"


def digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_added_as_files_and_entries_runs(tmp_path):
    shutil.copytree(core.HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digests(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())

    cfg = tiny(core.load_json(core.ROOT / "benchmark/configs/IANv1-fp32.json"))
    cfg["name"] = "IANv1-tiny"
    (tmp_path / "benchmark/configs/IANv1-tiny.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark/traffic/encdec_b4.json").write_text(json.dumps(
        {"kind": "encdec", "batch": 4, "pool_batches": 2, "check_batches": 2, "trace_seconds": 0.5}))
    (tmp_path / f"benchmark/limits/{CELL}.json").write_text(json.dumps({"encode_z": 1e-3, "decode_image": 1e-3}))
    (tmp_path / "benchmark/metrics/batches_per_s.py").write_text(textwrap.dedent('''
        """Batches the traced window completed per second of it."""


        def read(run):
            return run.work / run.window_s if run.window_s else None
    '''))
    bench["configs"].append({"name": "IANv1-tiny", "source": cfg["source"], "file": "benchmark/configs/IANv1-tiny.json",
                             "reduced": ["encoder", "decoder", "discriminator"], "why": "a test's"})
    bench["workloads"].append({"name": CELL, "config": "IANv1-tiny", "traffic": "encdec_b4", "chips": 1,
                               "why": "a test's"})
    bench["end_to_end"].append({"name": "encdec_imgs_per_s.tiny", "unit": "imgs/s", "better": "higher", "bound": 0.25,
                                "source": "host_clock", "workloads": [CELL]})
    bench["per_layer"].append({"name": "batches_per_s.encdec", "unit": "batches/s", "better": "higher",
                               "source": "host_clock", "layer": "entry points", "moves": "encdec_imgs_per_s.tiny",
                               "workloads": [CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = textwrap.dedent(f"""
        import json, sys, time
        sys.path[:0] = [{str(tmp_path)!r}, {str(core.ROOT)!r}]
        from benchmark import core
        assert core.ROOT.as_posix() == {tmp_path.as_posix()!r}
        out = [core.execute(core.Run({CELL!r}, 9, 0.5, trace, "cpu"), time.perf_counter()) for trace in (0, 1)]
        print(json.dumps(out))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = json.loads(out.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"encdec_imgs_per_s.tiny", "setup_s"}
    assert "batches_per_s.encdec" in traced["metrics"]
    after = digests(tmp_path)
    assert all(after[k] == v for k, v in before.items())
