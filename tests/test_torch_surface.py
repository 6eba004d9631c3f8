"""The port's surface held to the JAX package's, by reading source only.

Every module of the JAX package (`deepdenoiser_tpu/**/*.py`), every tool
(`tools/*.py`, `tools/*.sh`) and the root `bench.py` has a counterpart in
`deepdenoiser_tpu_torch/` at the same relative path (tools under
`deepdenoiser_tpu_torch/tools/`). Each public top-level name of a JAX
module (a `def`, a `class`, a plain or annotated assignment, or the
entries of `__all__` where a module has one; imports are not counted on
either side) has a counterpart of the same name in its port, and each
`add_argument("--...")` flag and `add_parser(...)` subcommand of a JAX
entry point exists in its port.

A deliberate difference is recorded here and nowhere else: in RENAMED
(JAX key -> the port's key) or in NOT_PORTED (JAX key -> why). A key is a
repo-relative path, or `path::item` for a name, a flag (`--x`) or a
subcommand (`subcommand x`). An entry goes stale, and fails the test,
when the JAX package no longer has its key, when the port has the key's
item under its own name, or when a rename's target is missing.

Nothing of either package is imported: the files are parsed with `ast`.
"""

import ast
from pathlib import Path
from typing import Dict, List, Mapping, Set

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = "deepdenoiser_tpu", "deepdenoiser_tpu_torch"

_ARRAY_ALIAS = ("a jax.Array type alias for annotations; the port annotates with torch.Tensor "
                "(`Tensor` where a module names it)")
_WEDGED = ("bench.py's wedged-chip degraded mode, which falls back to the CPU by itself; the "
           "port has no silent CPU fallback: the quality-only record is `--device cpu` only")
_XLA_COST = ("reads XLA's compiled cost analysis; the port's traffic_breakdown lists one "
             "frame's ops by a TorchDispatchMode (`op_table`) instead")

RENAMED: Dict[str, str] = {
    f"{JAX_PKG}/data/synthetic_jax.py": f"{PORT_PKG}/data/synthetic_device.py",
    f"{JAX_PKG}/ops/kpn_pallas.py": f"{PORT_PKG}/ops/kpn_apply.py",
    "bench.py": f"{PORT_PKG}/tools/bench.py",
    "tools/sweep_4k.sh": f"{PORT_PKG}/tools/sweep_4k.py",
    f"{JAX_PKG}/models/factory.py::init_params": f"{PORT_PKG}/models/factory.py::init_model",
    f"{JAX_PKG}/data/loader.py::input_channels": f"{PORT_PKG}/config.py::input_channels",
    f"{JAX_PKG}/data/loader.py::output_channels": f"{PORT_PKG}/config.py::output_channels",
    f"{JAX_PKG}/data/mc_tracer.py::make_scene_jax": f"{PORT_PKG}/data/mc_tracer.py::make_scene_random",
    f"{JAX_PKG}/ops/fused_ingest.py::encode_group_inputs_pallas":
        f"{PORT_PKG}/ops/fused_ingest.py::encode_groups_fused",
    f"{JAX_PKG}/ops/kpn_pallas.py::apply_per_pixel_kernels_pallas":
        f"{PORT_PKG}/ops/kpn_apply.py::apply_per_pixel_kernels",
    "tools/eval_zoo.py::ROOT": f"{PORT_PKG}/tools/pretrain_flagship.py::REPO_ROOT",
    "tools/eval_zoo.py::--cpu": f"{PORT_PKG}/tools/eval_zoo.py::--device",
    "tools/bench_input_pipeline.py::--cpu": f"{PORT_PKG}/tools/bench_input_pipeline.py::--device",
    f"{JAX_PKG}/models/layers.py::ACTIVATIONS": f"{PORT_PKG}/ops/bias_act.py::ACTIVATIONS",
}

NOT_PORTED: Dict[str, str] = {
    f"{JAX_PKG}/utils/tpu_guard.py": "guards the shared TPU against a second client; TPU-only",
    "tools/check_pallas_tpu.py": "compiles the Pallas kernels for the TPU; tests/test_torch_gpu.py "
                                 "builds and checks the port's CUDA kernels",
    "tools/dump_hlo.py": "dumps XLA's HLO; there is no XLA program in the port",
    "tools/watchdog_train.sh": "restarts training on a wedged TPU; TPU-only",
    f"{JAX_PKG}/parallel/mesh.py::batch_sharded": "a JAX sharding spec; the port's Mesh places "
                                                  "bands and batches on devices itself",
    f"{JAX_PKG}/parallel/mesh.py::replicated": "a JAX sharding spec (see batch_sharded)",
    "tools/traffic_breakdown.py::cost": _XLA_COST,
    "tools/traffic_breakdown.py::shape_bytes": _XLA_COST,
    "tools/traffic_breakdown.py::top_ops": _XLA_COST,
    "bench.py::--probe-timeout": _WEDGED,
    "bench.py::--wedged-height": _WEDGED,
    "bench.py::--wedged-width": _WEDGED,
    "bench.py::WEDGED_H": _WEDGED,
    "bench.py::WEDGED_W": _WEDGED,
    f"{JAX_PKG}/models/layers.py::Dtype": "a Flax dtype alias; the port passes torch.dtype",
    f"{JAX_PKG}/models/layers.py::activation": "the port applies a conv's activation by name "
                                               "in ops/bias_act.py with its bias; ConvBlock "
                                               "checks the name",
    **{f"{JAX_PKG}/{m}::Array": _ARRAY_ALIAS for m in (
        "data/loader.py", "data/mc_tracer.py", "data/synthetic_jax.py", "inference/pipeline.py",
        "inference/sequence.py", "inference/tiled.py", "models/factory.py", "models/kpn.py",
        "models/layers.py", "models/multiscale.py", "models/tiramisu.py", "models/unet.py",
        "ops/fused_ingest.py", "ops/kpn_pallas.py", "ops/losses.py", "ops/metrics.py",
        "parallel/halo.py", "training/train.py", "transforms.py")},
}


def jax_modules(repo: Path) -> List[str]:
    """Repo-relative paths of the JAX package's modules, tools and bench.py."""
    mods = sorted(p.relative_to(repo).as_posix() for p in (repo / JAX_PKG).rglob("*.py"))
    tools = repo / "tools"
    if tools.is_dir():
        mods += sorted(p.relative_to(repo).as_posix() for p in tools.iterdir()
                       if p.suffix in (".py", ".sh"))
    if (repo / "bench.py").exists():
        mods.append("bench.py")
    return mods


def own_port_path(rel: str) -> str:
    """Where the port keeps `rel` when it keeps it under the same name."""
    if rel.startswith(JAX_PKG + "/"):
        return PORT_PKG + rel[len(JAX_PKG):]
    return f"{PORT_PKG}/{rel}"


def _is_main_guard(node: ast.If) -> bool:
    t = node.test
    return (isinstance(t, ast.Compare) and isinstance(t.left, ast.Name)
            and t.left.id == "__name__")


def _top_names(body: List[ast.stmt], out: Set[str]) -> None:
    for n in body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            for t in n.targets if isinstance(n, ast.Assign) else [n.target]:
                out.update(e.id for e in ast.walk(t) if isinstance(e, ast.Name))
        elif isinstance(n, ast.If) and not _is_main_guard(n):
            _top_names(n.body, out)
            _top_names(n.orelse, out)
        elif isinstance(n, ast.Try):
            for b in (n.body, n.orelse, n.finalbody, *(h.body for h in n.handlers)):
                _top_names(b, out)


def _all_list(tree: ast.Module):
    for n in tree.body:
        if isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            if any(isinstance(t, ast.Name) and t.id == "__all__" for t in targets):
                return {e.value for e in ast.walk(n.value)
                        if isinstance(e, ast.Constant) and isinstance(e.value, str)}
    return None


def surface(path: Path) -> Set[str]:
    """A module's public names, flags (`--x`) and subcommands (`subcommand x`);
    a shell script has none of its own."""
    if path.suffix != ".py":
        return set()
    tree = ast.parse(path.read_text(), filename=str(path))
    names = _all_list(tree)
    if names is None:
        found: Set[str] = set()
        _top_names(tree.body, found)
        names = {n for n in found if not n.startswith("_")}
    items = set(names)
    for n in ast.walk(tree):
        if not (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)):
            continue
        consts = [a.value for a in n.args if isinstance(a, ast.Constant) and isinstance(a.value, str)]
        if n.func.attr == "add_argument":
            items.update(c for c in consts if c.startswith("--"))
        elif n.func.attr == "add_parser" and consts:
            items.add(f"subcommand {consts[0]}")
    return items


def check_module(rel: str, repo: Path = REPO, renamed: Mapping[str, str] = RENAMED,
                 not_ported: Mapping[str, str] = NOT_PORTED) -> List[str]:
    """What the port lacks of JAX module `rel`, and every stale exception
    keyed to it; empty when the module's surface is held."""
    own = own_port_path(rel)
    if rel in not_ported:
        return [f"{rel}: listed in NOT_PORTED, but the port has {own}"] if (repo / own).exists() \
            else []
    problems = []
    if rel in renamed and (repo / own).exists():
        problems.append(f"{rel}: listed in RENAMED, but the port has {own} under its own name")
    port = renamed.get(rel, own)
    if not (repo / port).exists():
        return problems + [f"{rel}: the port has no {port}"]
    jax_items, port_items = surface(repo / rel), surface(repo / port)
    for item in sorted(jax_items):
        key = f"{rel}::{item}"
        if key in not_ported:
            if item in port_items:
                problems.append(f"{key}: listed in NOT_PORTED, but {port} has {item!r}")
        elif key in renamed:
            if item in port_items:
                problems.append(f"{key}: listed in RENAMED, but {port} has {item!r}")
            target, _, target_item = renamed[key].partition("::")
            if not (repo / target).exists() or target_item not in surface(repo / target):
                problems.append(f"{key}: its rename {renamed[key]} is not in the port")
        elif item not in port_items:
            problems.append(f"{key}: missing in {port}")
    for key in (*renamed, *not_ported):
        path, sep, item = key.partition("::")
        if sep and path == rel and item not in jax_items:
            problems.append(f"{key}: stale, {rel} has no {item!r}")
    return problems


def check_exceptions(repo: Path = REPO, renamed: Mapping[str, str] = RENAMED,
                     not_ported: Mapping[str, str] = NOT_PORTED) -> List[str]:
    """Entries keyed to no JAX module, entries in both dicts, reasons left empty."""
    mods = set(jax_modules(repo))
    problems = [f"{k}: in both RENAMED and NOT_PORTED" for k in sorted(set(renamed) & set(not_ported))]
    problems += [f"{k}: stale, the JAX package has no {k.partition('::')[0]}"
                 for k in sorted({*renamed, *not_ported}) if k.partition("::")[0] not in mods]
    problems += [f"{k}: NOT_PORTED without a reason" for k, why in not_ported.items()
                 if not why.strip()]
    return problems


@pytest.mark.parametrize("rel", jax_modules(REPO))
def test_the_port_holds_the_jax_module_surface(rel):
    assert check_module(rel) == []


def test_every_exception_names_a_jax_module_and_stands_in_one_dict():
    assert check_exceptions() == []


def test_the_checker_reports_missing_names_flags_and_stale_exceptions(tmp_path):
    files = {
        f"{JAX_PKG}/a.py": (
            "import argparse\n"
            "from typing import Dict\n"
            "TABLE: Dict[str, int] = {}\n"
            "def kept(): pass\n"
            "def lost(): pass\n"
            "def _private(): pass\n"
            "def old_name(): pass\n"
            "def main():\n"
            "    p = argparse.ArgumentParser()\n"
            "    p.add_argument('--kept')\n"
            "    p.add_argument('--lost', type=int)\n"
            "    p.add_subparsers().add_parser('run')\n"
            "if __name__ == '__main__':\n"
            "    args = main()\n"),
        f"{PORT_PKG}/a.py": (
            "import argparse\n"
            "TABLE = {}\n"
            "def kept(): pass\n"
            "def new_name(): pass\n"
            "def main():\n"
            "    argparse.ArgumentParser().add_argument('--kept')\n"),
        f"{JAX_PKG}/b.py": "__all__ = ['shown']\ndef shown(): pass\ndef hidden(): pass\n"
                           "def tpu_only(): pass\n",
        f"{PORT_PKG}/b.py": "def shown(): pass\ndef tpu_only(): pass\n",
    }
    for rel, text in files.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(text)
    renamed = {f"{JAX_PKG}/a.py::old_name": f"{PORT_PKG}/a.py::new_name",
               f"{JAX_PKG}/a.py::gone": f"{PORT_PKG}/a.py::kept"}
    not_ported = {f"{JAX_PKG}/b.py::shown": "stale: the port has it",
                  f"{JAX_PKG}/c.py::x": "stale: no such module"}
    assert jax_modules(tmp_path) == [f"{JAX_PKG}/a.py", f"{JAX_PKG}/b.py"]
    a = f"{JAX_PKG}/a.py"
    assert check_module(a, tmp_path, renamed, not_ported) == [
        f"{a}::--lost: missing in {PORT_PKG}/a.py",
        f"{a}::lost: missing in {PORT_PKG}/a.py",
        f"{a}::subcommand run: missing in {PORT_PKG}/a.py",
        f"{a}::gone: stale, {a} has no 'gone'",
    ]
    b = f"{JAX_PKG}/b.py"
    assert check_module(b, tmp_path, renamed, not_ported) == [
        f"{b}::shown: listed in NOT_PORTED, but {PORT_PKG}/b.py has 'shown'"]
    assert check_module(b, tmp_path, renamed, {}) == []  # __all__ hides `hidden`
    assert check_exceptions(tmp_path, renamed, not_ported) == [
        f"{JAX_PKG}/c.py::x: stale, the JAX package has no {JAX_PKG}/c.py"]
    (tmp_path / PORT_PKG / "a.py").unlink()
    assert check_module(a, tmp_path, renamed, not_ported) == [f"{a}: the port has no {PORT_PKG}/a.py"]
