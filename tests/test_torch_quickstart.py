"""examples/quickstart_torch.sh, parsed and not run: each of its CLI calls
is accepted by the port's argparse, with the device the script asks for;
its steps, flags and config are examples/quickstart.sh's; and its config
block builds and saves with the port's config module.
"""

import re
import shlex
import string
from pathlib import Path

import pytest

from deepdenoiser_tpu_torch import cli
from deepdenoiser_tpu_torch import config as config_lib

REPO = Path(__file__).resolve().parents[1]
PORT_SCRIPT = REPO / "examples" / "quickstart_torch.sh"
JAX_SCRIPT = REPO / "examples" / "quickstart.sh"
STEPS = ["synth-data", "prepare-data", "train", "denoise", "eval"]


def _cli_calls(script: Path, module: str) -> list:
    """The argument strings of each `$PY -m <module> ...` call, continuation
    lines joined."""
    text = script.read_text().replace("\\\n", " ")
    return re.findall(rf"^\$PY -m {re.escape(module)} (.*)$", text, flags=re.M)


def _heredoc(script: Path) -> str:
    return re.search(r"<<EOF\n(.*?)\nEOF\n", script.read_text(), flags=re.S).group(1)


def _argv(call: str, device_flag: str, tmp_path: Path) -> list:
    return shlex.split(string.Template(call).substitute(
        WORK=str(tmp_path), FRAME=str(tmp_path / "renders" / "frame0000" / "spp4_seed0"),
        DEVICE_FLAG=device_flag))


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("step", range(len(STEPS)))
def test_each_cli_call_parses_with_the_device_asked_for(tmp_path, step, device):
    calls = _cli_calls(PORT_SCRIPT, "deepdenoiser_tpu_torch.cli")
    assert len(calls) == len(STEPS)
    flag = "--device cpu" if device == "cpu" else ""
    args = cli.build_parser().parse_args(_argv(calls[step], flag, tmp_path))
    assert args.command == STEPS[step]
    # a command that takes --device has its default ("cuda") when not given it
    takes_device = hasattr(cli.build_parser().parse_args(_argv(calls[step], "", tmp_path)),
                           "device")
    assert getattr(args, "device", None) == (device if takes_device else None)
    assert takes_device == (STEPS[step] in ("train", "denoise", "eval"))


def test_the_steps_flags_and_config_are_the_jax_quickstarts(tmp_path):
    port = [_argv(c, "", tmp_path) for c in _cli_calls(PORT_SCRIPT, "deepdenoiser_tpu_torch.cli")]
    jax = [_argv(c, "", tmp_path) for c in _cli_calls(JAX_SCRIPT, "deepdenoiser_tpu.cli")]
    assert port == jax and [a[0] for a in port] == STEPS
    assert _heredoc(PORT_SCRIPT) == _heredoc(JAX_SCRIPT).replace(
        "from deepdenoiser_tpu import", "from deepdenoiser_tpu_torch import")


def test_the_config_block_saves_a_config_the_port_loads(tmp_path):
    code = string.Template(_heredoc(PORT_SCRIPT)).substitute(WORK=str(tmp_path))
    exec(compile(code, str(PORT_SCRIPT), "exec"), {})
    cfg = config_lib.load(tmp_path / "config.json")
    assert cfg.data.mode == "rgb" and cfg.train.steps == 300
    assert cfg.model.base_width == 16 and cfg.model.predict_residual


def test_the_default_work_directory_is_git_ignored_in_the_checkout():
    """With no argument the script writes inside its own checkout (it cd's
    to the root), in a directory git ignores, so two checkouts on one
    machine never share renders, shards or checkpoints."""
    work = re.search(r"^WORK=\$\{1:-(.*)\}$", PORT_SCRIPT.read_text(), flags=re.M).group(1)
    assert not Path(work).is_absolute() and ".." not in Path(work).parts
    ignored = [ln.strip().rstrip("/") for ln in (REPO / ".gitignore").read_text().splitlines()]
    assert Path(work).parts[0] in ignored
