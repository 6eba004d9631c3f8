"""The harness's one door into the program (deepdenoiser_tpu_torch): the
cell's configuration as the program's ExperimentConfig. Imported lazily,
so the registry, the generator, the counters and the references load
without the program."""

from __future__ import annotations

from h100_bench import registry


def settings(cell: registry.Cell) -> dict:
    """The configuration file without its "bench" group, with the traffic's
    "train" settings (a training recipe) and the cell's "infer" and "train"
    overrides applied: a plain dict, what the references read."""
    d = {k: v for k, v in cell.config.items() if k != "bench"}
    t_train, w_train = cell.traffic.get("train", {}), cell.workload.get("train", {})
    train = {**d["train"], **t_train, **w_train}
    train["loss"] = {**d["train"]["loss"], **t_train.get("loss", {}), **w_train.get("loss", {})}
    return {**d, "train": train, "infer": {**d["infer"], **cell.workload.get("infer", {})}}


def experiment(cell: registry.Cell):
    """settings(cell) as the program's ExperimentConfig."""
    from deepdenoiser_tpu_torch import config as dd_config

    return dd_config.from_dict(dd_config.ExperimentConfig, settings(cell))
