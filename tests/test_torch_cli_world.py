"""The CLIs over a launcher's world (``torchrun``), on the CPU.

``python -m repro_torch.launch.serve --model-axis m`` and
``python -m repro_torch.launch.train --model-axis m`` under ``torchrun
--nproc-per-node 4`` lay the model over a (4 / m, m) gloo mesh of the
four ranks: the server gives the meshless CLI's tokens (greedy and
sampled, from the same full logits on every rank) and the trainer its
losses, and only rank 0 prints.  Without a mesh (``--model-axis 0``) in
a world of more than one rank both CLIs raise, naming the flag (each
rank would otherwise run its own meshless copy); a world of one keeps
the meshless path.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import mesh as M
from repro_torch.launch import serve, train

ROOT = Path(__file__).resolve().parent.parent


def _env() -> dict:
    return dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
                PYTHONPATH=os.pathsep.join(
                    [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))


def _meshless(module: str, *args: str) -> str:
    proc = subprocess.run([sys.executable, "-m", module, *args], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def _torchrun(tmp_path, module: str, *args: str) -> list[str]:
    """``module``'s CLI in a 4-rank world of ``torchrun --standalone``;
    each rank's standard output."""
    logs = tmp_path / "logs"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "--log-dir", str(logs), "--redirects", "3",
         "-m", module, *args], env=_env(), capture_output=True, text=True,
        timeout=180)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    outs = {int(p.parent.name): p.read_text()
            for p in logs.rglob("stdout.log")}
    assert sorted(outs) == [0, 1, 2, 3]
    return [outs[r] for r in range(4)]


@pytest.mark.parametrize("model_axis", [2, 4])
def test_serve_cli_on_a_4_rank_mesh_serves_the_meshless_tokens(
        model_axis, tmp_path):
    args = ("--reduced", "--device", "cpu", "--gen", "8")
    want = _meshless("repro_torch.launch.serve", *args)
    outs = _torchrun(tmp_path, "repro_torch.launch.serve", *args,
                     "--model-axis", str(model_axis))
    assert outs[1:] == ["", "", ""]

    def tokens(text):
        return re.findall(r"req \d+: \[.*\]", text)
    assert len(tokens(want)) == 4 and tokens(outs[0]) == tokens(want)


def test_train_cli_on_a_4_rank_mesh_gives_the_meshless_losses(tmp_path):
    args = ("--reduced", "--device", "cpu", "--steps", "3", "--batch", "4",
            "--seq", "8", "--ckpt-every", "0")
    want = _meshless("repro_torch.launch.train", *args, "--ckpt-dir",
                     str(tmp_path / "none"))
    outs = _torchrun(tmp_path, "repro_torch.launch.train", *args,
                     "--ckpt-dir", str(tmp_path / "mesh"), "--model-axis",
                     "2")
    assert outs[1:] == ["", "", ""]

    def losses(text):
        return re.findall(r"loss (\d+\.\d+) -> (\d+\.\d+)", text)
    assert len(losses(want)) == 1 and losses(outs[0]) == losses(want)


@pytest.mark.parametrize("cli", [serve, train], ids=["serve", "train"])
def test_cli_without_a_mesh_raises_in_a_world_of_many(cli, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setattr(sys, "argv", [cli.__name__, "--reduced", "--device",
                                      "cpu", "--model-axis", "0"])
    with pytest.raises(ValueError, match="--model-axis"):
        cli.main()


def test_a_world_of_one_keeps_the_meshless_path(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert M.cli_mesh(0, "cpu") is None
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert M.cli_mesh(0, "cpu") is None
