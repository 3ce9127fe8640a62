"""The kernel build's inter-process lock (``photon_tpu_torch/ops/_build.py``):
node processes spawned together build a source once. The compiler is
replaced by a stand-in that records each call and takes two seconds (no
``nvcc`` here), so the second process arrives while the first holds the
lock; it must wait, then load the first one's library and report no
build time of its own.
"""

import multiprocessing as mp
import os
import pathlib
import time

from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

SOURCE = "k.cu"


def _build_in_child(build_dir: str, csrc: str, log: str, results) -> None:
    from photon_tpu_torch.ops import _build

    _build.BUILD_DIR, _build.CSRC = pathlib.Path(build_dir), pathlib.Path(csrc)

    def compile_stand_in(source, out):
        with open(log, "a") as f:
            f.write(f"{os.getpid()}\n")
        time.sleep(2.0)
        tmp = out.with_suffix(f".tmp-{os.getpid()}.so")
        tmp.write_bytes(b"library")
        os.replace(tmp, out)
        _build.build_seconds[source] = 2.0
        return out

    _build._compile = compile_stand_in
    t0 = time.perf_counter()
    path = _build.build(SOURCE)
    results.put((os.getpid(), str(path), _build.build_seconds[SOURCE], time.perf_counter() - t0))


def test_processes_building_one_source_run_the_compiler_once(tmp_path):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / SOURCE).write_text("// a kernel\n")
    log = tmp_path / "compiles.log"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_build_in_child,
                         args=(str(tmp_path / "build"), str(tmp_path / "csrc"), str(log), results))
             for _ in range(2)]
    for p in procs:
        p.start()
    got = [results.get(timeout=60) for _ in procs]
    for p in procs:
        p.join(timeout=30)
        assert p.exitcode == 0
    assert len(log.read_text().split()) == 1  # one compile for both processes
    assert got[0][1] == got[1][1] and pathlib.Path(got[0][1]).read_bytes() == b"library"
    compiled = [g for g in got if g[2] > 0]
    waited = [g for g in got if g[2] == 0.0]
    assert len(compiled) == len(waited) == 1
    assert waited[0][3] > 0.5  # it waited on the other process's lock
    assert not list((tmp_path / "build").glob("*.tmp-*"))
