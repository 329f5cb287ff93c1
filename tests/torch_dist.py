"""Start a multi-process run of tests/torch_dist_worker.py (gloo on the
CPU, one process per rank) and collect each rank's result."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from speech_inpainting_torch.parallel.distributed import join_world_of_one
from speech_inpainting_torch.parallel.mesh import free_port

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_dist_worker.py")


def env() -> dict:
    """The workers' environment: one thread each, the repository on the
    path, no launcher variables (a stray RANK would be read as one)."""
    e = {k: v for k, v in os.environ.items()
         if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                      "MASTER_PORT")}
    e.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
             PYTHONPATH=str(ROOT) + os.pathsep + e.get("PYTHONPATH", ""))
    return e


def run_ranks(argv_of, world: int, timeout: float = 240) -> list:
    """Start argv_of(rank) for every rank at once; wait for all; fail with
    each failed rank's output. Returns each rank's stdout."""
    procs = [subprocess.Popen(argv_of(r), cwd=ROOT, env=env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(r, p.returncode, o) for r, (p, o) in enumerate(zip(procs, outs))
           if p.returncode]
    assert not bad, "\n".join(f"rank {r} exited {rc}:\n{o[-4000:]}"
                              for r, rc, o in bad)
    return outs


def launch(case: str, world: int, inp: dict, tmp: Path,
           timeout: float = 240) -> list:
    """Run `case` on `world` ranks with inputs `inp`; each rank's output."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(inp, tmp / "in.pt")
    port = str(free_port())
    run_ranks(lambda r: [sys.executable, str(WORKER), case, str(r),
                         str(world), port, str(tmp)], world, timeout)
    return [torch.load(tmp / f"out{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture
def group_of_one():
    """A gloo process group of this process alone, for a mesh in the test
    process; left when the test ends."""
    join_world_of_one("cpu")
    yield
    dist.destroy_process_group()
