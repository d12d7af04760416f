"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip skipped, the rest of a run driven on the CPU at
a tiny size, once for each fault the cells can have.  (No cell runs across
chips, so no exchange between chips can be left out.)"""

import pytest
import torch

import xsdba_tpu_torch.models._algos as algos
from portbench import run

from .cells import CELLS

_QM, _QDM = algos.qm_adjust_core, algos.qdm_adjust_core


def _unchanged(sim, *a, **k):
    """A step that returns its state unchanged: scen is sim."""
    return sim


def _half(out):
    """Half of the batch left out, the mean of the rest in its place."""
    h = out.shape[0] // 2
    out = out.clone()
    out[h:] = out[:h].mean(dim=0, keepdim=True)
    return out


def _altered(out):
    """An answer altered where it is produced: one day's factors shifted
    by 0.05 K at every site."""
    out = out.clone()
    out[..., 40] += 0.05
    return out


def _tail_altered(out):
    """An answer altered in the block's last chunk of sites alone (the
    windowed path's partial last chunk: 1/13 of the sites, at least one)."""
    out = out.clone()
    out[-max(1, out.shape[0] // 13):] += 0.05
    return out


FAULTS = {
    "state_unchanged": (lambda sim, *a, **k: _unchanged(sim), lambda sim, *a, **k: (_unchanged(sim), torch.zeros_like(sim))),
    "half_batch_mean": (lambda *a, **k: _half(_QM(*a, **k)), lambda *a, **k: (lambda r: (_half(r[0]), r[1]))(_QDM(*a, **k))),
    "answer_altered": (lambda *a, **k: _altered(_QM(*a, **k)), lambda *a, **k: (lambda r: (_altered(r[0]), r[1]))(_QDM(*a, **k))),
    "tail_altered": (lambda *a, **k: _tail_altered(_QM(*a, **k)), lambda *a, **k: (lambda r: (_tail_altered(r[0]), r[1]))(_QDM(*a, **k))),
}


def _run(cell, root):
    return run.run(cell, 2**31 + 99, 0.2, False, "cpu", root=root, log=lambda s: None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, merge_engine, tiny_root):
    r = _run(cell, tiny_root)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "compared"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, merge_engine, monkeypatch, tiny_root):
    qm, qdm = FAULTS[fault]
    monkeypatch.setattr(algos, "qm_adjust_core", qm)
    monkeypatch.setattr(algos, "qdm_adjust_core", qdm)
    r = _run(cell, tiny_root)
    assert not r["correct"] and r["failed"] == r["attempted"] > 0
    assert r["compared"]["scen_max_abs_K"]["value"] > r["compared"]["scen_max_abs_K"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_fault_in_some_blocks_is_not_correct(cell, merge_engine, monkeypatch, tiny_root):
    """An answer altered in every third call alone: those blocks, and only
    those, fail, though their pool entry's other blocks repeat the sound
    answer bit for bit (eight blocks through the window's own calls)."""
    calls = []

    def every_third(core):
        def wrapped(*a, **k):
            calls.append(1)
            r = core(*a, **k)
            if len(calls) % 3:
                return r
            return _altered(r) if not isinstance(r, tuple) else (_altered(r[0]), *r[1:])
        return wrapped

    monkeypatch.setattr(algos, "qm_adjust_core", every_third(_QM))
    monkeypatch.setattr(algos, "qdm_adjust_core", every_third(_QDM))
    c = run.Cell(cell, tiny_root)
    c.setup(7, "cpu")
    for i in range(8):
        c.block(i)
    got, inputs = c.samples_to_host()
    c.free()
    r = c.verify(got, inputs)
    assert not r["correct"] and r["attempted"] == 8 and r["failed"] == 2   # calls 3 and 6 of 8
    assert len({id(g) for _, g in got}) == 2 + 2                            # two sound copies, two altered


@pytest.mark.parametrize("cell", CELLS)
def test_raising_block_is_not_correct(cell, merge_engine, monkeypatch, tiny_root):
    def boom(*a, **k):
        raise RuntimeError("a failed launch")

    monkeypatch.setattr(algos, "qm_adjust_core", boom)
    monkeypatch.setattr(algos, "qdm_adjust_core", boom)
    r = _run(cell, tiny_root)
    assert not r["correct"] and r["failed"] == r["attempted"] > 0
