"""`correct` is decided by a comparison that fails when it should: every
run of a cell on the CPU at test sizes (the harness's look for a card
skipped), first sound, then with the timed path broken underneath, and
with the control (the plain reference with float8 conv operands) put in
the program's place. Each broken run must read `correct` false under the
cell's own limits."""

import pytest
import torch

from h100_bench import harness
from h100_bench.tests.conftest import TRAIN

CPU = torch.device("cpu")
FRAMES = ["kpn-hq.1080p", "flagship-max.1080p", "kpn-hq.4k-tiled"]


def _run(bench, name, wrap=None, seed=21):
    return harness.run_cell(bench, name, seed, 0.3, False, CPU, 0.0, session_wrap=wrap)


@pytest.mark.parametrize("name", FRAMES + [TRAIN])
def test_a_sound_run_is_correct(small_bench, name):
    r = _run(small_bench, name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1 and list(r)[-1] == "checks"


def _frames_control(session):
    window = session.window

    def run(seconds, spans):
        rec = window(seconds, spans)
        f8 = session.references(f8=True)
        session.held = [(i, f, f8[f]) for i, f, _ in session.held]
        return rec

    session.window = run
    return session


def _train_control(session):
    session.readings = lambda: session.reference(f8=True)
    return session


@pytest.mark.parametrize("name", FRAMES + [TRAIN])
def test_the_float8_control_in_the_programs_place_is_not_correct(small_bench, name):
    r = _run(small_bench, name, _train_control if name == TRAIN else _frames_control)
    assert not r["correct"], r["checks"]


def test_an_answer_altered_where_it_is_produced_is_not_correct(small_bench, monkeypatch):
    from deepdenoiser_tpu_torch import transforms

    decode = transforms.decode_joint_outputs

    def altered(*a, **kw):
        out = decode(*a, **kw)
        out["glossy_indirect"] = out["glossy_indirect"] * 1.05
        return out

    monkeypatch.setattr(transforms, "decode_joint_outputs", altered)
    r = _run(small_bench, "kpn-hq.1080p")
    assert not r["correct"], r["checks"]


def _half_batch_network(session):
    """The network computes the first half of its batch (groups or tiles)
    and hands those outputs out for the rest too."""
    model = session.denoise.model
    forward = model.forward

    def half(x, *a, **kw):
        n = x.shape[0]
        y = forward(x[: max(n // 2, 1)], *a, **kw)
        return torch.cat([y] * 2)[:n] if n > 1 else y * 0.5

    model.forward = half
    return session


@pytest.mark.parametrize("name", ["flagship-max.1080p", "kpn-hq.4k-tiled"])
def test_half_of_the_batch_left_out_is_not_correct(small_bench, name):
    r = _run(small_bench, name, _half_batch_network)
    assert not r["correct"], r["checks"]


def _unchanged_state(step):
    """The step runs, and the parameters come back as they were."""

    def unchanged(state, batch):
        before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        state, mets = step(state, batch)
        with torch.no_grad():
            for n, p in state.model.named_parameters():
                p.copy_(before[n])
        return state, mets

    return unchanged


def _half_train_batch(step):
    """The step trains on the first half of each batch, its loss the mean
    over that half."""
    return lambda state, batch: step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})


@pytest.mark.parametrize("fault", [_unchanged_state, _half_train_batch])
def test_a_broken_train_step_is_not_correct(small_bench, monkeypatch, fault):
    from deepdenoiser_tpu_torch.training import train as train_lib

    make = train_lib.make_train_step
    monkeypatch.setattr(train_lib, "make_train_step", lambda *a, **kw: fault(make(*a, **kw)))
    r = _run(small_bench, TRAIN)
    assert not r["correct"], r["checks"]
