"""Processes joined into one world (qwen3_tpu_torch/parallel/multihost.py,
launch.py) on the CPU over gloo, as tests/test_multihost.py joins JAX
processes: two OS processes through the CLI's --coordinator, the CLI's own
--tp ranks and serve.py's --tp/--dp ranks, each against the single-process
run; and the plumbing around them (the kernel build before the ranks
start, the refusals that stay)."""

import json
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from qwen3_tpu_torch import cli  # noqa: E402
from qwen3_tpu_torch.config import PRESETS  # noqa: E402
from qwen3_tpu_torch.io.checkpoint import write_checkpoint  # noqa: E402
from qwen3_tpu_torch.io.synthetic import (  # noqa: E402
    synthetic_tokenizer,
    synthetic_weights,
)
from qwen3_tpu_torch.io.tokenizer_bin import write_tokenizer_bin  # noqa: E402
from qwen3_tpu_torch.ops.cuda import build  # noqa: E402
from qwen3_tpu_torch.parallel import launch  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 240

# two processes: a sum and a gather over a (1, 2) mesh, the seed of
# process 0, and which process is primary
_REDUCE_WORKER = textwrap.dedent("""
    import sys
    import torch
    from qwen3_tpu_torch.parallel import multihost
    pid, addr = int(sys.argv[1]), sys.argv[2]
    multihost.initialize(addr, 2, pid, device="cpu")
    mesh = multihost.global_mesh(tp=2, device="cpu")
    g = mesh.tp_group
    x = torch.full((3,), float(pid + 1))
    assert g.sum(x).tolist() == [3.0, 3.0, 3.0]
    assert g.cat(x[:1], 0).tolist() == [1.0, 2.0]
    assert g.broadcast(x, 1).tolist() == [2.0, 2.0, 2.0]
    seed = multihost.agree_seed(100 + pid)
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "qwen3_tpu")]
    print(f"OK pid={pid} primary={multihost.is_primary()} seed={seed} "
          f"tp_idx={mesh.tp_idx} jax={bad}")
""")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh")
    cfg = PRESETS["tiny"]
    path = str(d / "tiny.bin")
    write_checkpoint(path, synthetic_weights(cfg, seed=3))
    write_tokenizer_bin(path + ".tokenizer",
                        synthetic_tokenizer(cfg.vocab_size))
    return path


def _run(argv, stdin=""):
    return subprocess.run([sys.executable, *argv], cwd=REPO, input=stdin,
                          capture_output=True, text=True, timeout=TIMEOUT,
                          errors="surrogateescape")


def _two(argv_of):
    """Start two processes (argv_of(i) each) and wait for both."""
    procs = [subprocess.Popen([sys.executable, *argv_of(i)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, errors="surrogateescape")
             for i in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def test_two_process_reduction():
    addr = f"127.0.0.1:{launch.free_port()}"
    res = _two(lambda i: ["-c", _REDUCE_WORKER, str(i), addr])
    for i, (rc, out, err) in enumerate(res):
        assert rc == 0, err[-3000:]
        assert (f"OK pid={i} primary={i == 0} seed=100 tp_idx={i} jax=[]"
                in out), out


CLI = ["-m", "qwen3_tpu_torch.cli"]
COMPLETE = ["-m", "completion", "-i", "the cat in the hat", "-t", "0", "-s",
            "5", "-c", "64", "--max-tokens", "40", "--device", "cpu"]


def test_two_process_cli_matches_single(ckpt):
    """--coordinator in two processes: process 0 prints the single-process
    greedy stream; process 1 writes nothing."""
    single = _run(CLI + [ckpt] + COMPLETE)
    assert single.returncode == 0, single.stderr
    addr = f"127.0.0.1:{launch.free_port()}"
    res = _two(lambda i: CLI + [ckpt] + COMPLETE + [
        "--tp", "2", "--coordinator", addr, "--num-processes", "2",
        "--process-id", str(i)])
    (rc0, out0, err0), (rc1, out1, err1) = res
    assert rc0 == 0 and rc1 == 0, err0[-3000:]
    assert out0 == single.stdout and len(single.stdout) > 40
    assert "[Mesh] dp=1 tp=2 backend=gloo" in err0
    assert out1 == "" and err1 == ""


def test_spawned_tp_ranks_match_single(ckpt):
    """--tp 2 starts its second rank itself: the same greedy stdout as one
    process; a seeded run and a chat turn (rank 0 reads stdin) run."""
    one, two = _run(CLI + [ckpt] + COMPLETE), _run(CLI + [ckpt] + COMPLETE
                                                  + ["--tp", "2"])
    assert one.returncode == 0 and two.returncode == 0, two.stderr
    assert two.stdout == one.stdout
    assert "backend=gloo ranks 0->cpu" in two.stderr
    seeded = COMPLETE[:COMPLETE.index("-t")] + ["-t", "0.8"] + COMPLETE[
        COMPLETE.index("-t") + 2:]
    two = _run(CLI + [ckpt] + seeded + ["--tp", "2"])
    assert two.returncode == 0 and two.stdout.startswith("the cat in the hat")
    chat = _run(CLI + [ckpt, "-m", "chat", "-s", "7", "-c", "64", "--device",
                       "cpu", "--tp", "2"], stdin="hi there\n\n")
    assert chat.returncode == 0, chat.stderr
    assert chat.stdout.count("> ") == 2


def test_serve_tp_dp_ranks_match_single(ckpt, tmp_path):
    pfile = tmp_path / "p.txt"
    pfile.write_text("the cat\nin the hat and\ner on at\nthe the\n")
    argv = ["-m", "qwen3_tpu_torch.serve", ckpt, "--prompts", str(pfile),
            "-t", "0", "-c", "64", "--max-tokens", "12", "--batch", "4",
            "--prefill-bucket", "16", "--decode-chunk", "8", "--qmode",
            "pallas", "--device", "cpu"]

    def records(extra):
        res = _run(argv + extra)
        assert res.returncode == 0, res.stderr[-3000:]
        return sorted((r["id"], r["text"], r["n_tokens"])
                      for r in map(json.loads, res.stdout.splitlines()))

    want = records([])
    assert records(["--tp", "2", "--dp", "2"]) == want


@pytest.mark.parametrize("bad", [0, 1])
def test_failed_rank_ends_the_run(bad):
    """A rank that raises ends the whole run at once, with a non-zero exit
    and its traceback on rank 0's stderr, where the other ranks would wait
    in their collectives (rank 0 is the launching process itself)."""
    code = ("import sys; sys.path.insert(0, 'tests')\n"
            "import torch_tp_ranks as R\n"
            "from qwen3_tpu_torch.parallel import launch\n"
            f"sys.exit(launch.run_ranks(R.fail_on_rank, 2, ({bad},), "
            "device='cpu'))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert f"rank {bad} fails on purpose" in res.stderr, res.stderr[-3000:]


def test_multihost_chat_returns_1(ckpt, capsys):
    """Chat under --coordinator is refused with rc 1 (the JAX CLI's rule),
    before any process joins."""
    assert cli.main([ckpt, "-m", "chat", "--coordinator", "127.0.0.1:1",
                     "--num-processes", "2", "--process-id", "0", "--tp",
                     "2", "--device", "cpu"]) == 1
    assert "single-host" in capsys.readouterr().err


def test_num_processes_must_equal_tp(ckpt, capsys):
    for flags in (["--num-processes", "2", "--process-id", "0"],
                  ["--coordinator", "127.0.0.1:1", "--num-processes", "2",
                   "--process-id", "0"]):
        assert cli.main([ckpt, "-m", "completion", "-i", "hi", "--device",
                         "cpu"] + flags) == 2
    err = capsys.readouterr().err
    assert "go together" in err and "must equal --tp" in err


def test_cli_spawn_path_builds_once(ckpt, monkeypatch):
    """The CLI builds the kernels in the parent, once, before it starts the
    ranks (which then find the library fresh)."""
    calls = []
    monkeypatch.setattr(build, "ensure_built", lambda: calls.append("build"))
    monkeypatch.setattr(
        launch, "run_ranks",
        lambda fn, world, args, device: calls.append(("ranks", world, device))
        or 0)
    assert cli.main([ckpt, "-m", "completion", "-i", "hi", "--tp", "2",
                     "--device", "cuda"]) == 0
    assert calls == ["build", ("ranks", 2, "cuda")]
    calls.clear()
    assert cli.main([ckpt, "-m", "completion", "-i", "hi", "--tp", "2",
                     "--device", "cpu"]) == 0
    assert calls == [("ranks", 2, "cpu")]


def test_concurrent_builds_build_once(tmp_path, monkeypatch):
    """ensure_built holds the build lock: of two ranks that find the library
    stale at once, the second waits and finds it built."""
    lib = tmp_path / "lib.so"
    built = []

    def fake_build():
        built.append(1)
        lib.write_text("built")

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "stale", lambda: not lib.exists())
    monkeypatch.setattr(build, "build", fake_build)
    threads = [threading.Thread(target=build.ensure_built) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert built == [1]
