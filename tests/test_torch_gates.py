"""The mutation check of the chip smoke's accuracy gates
(``chip_gate_mutation.py``) holds on the CPU as far as it can without a
card: every mutant names a line that occurs exactly once in its kernel
source, so that the copy it edits really carries the mutant, and the
edit changes that line and nothing else.  The card run makes the same
check before it runs a mutant; this keeps a kernel edit from silently
orphaning a mutant between card runs."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "chip_gate_mutation", ROOT / "chip_gate_mutation.py")
M = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(M)


def test_mutants_have_unique_names_and_known_phases():
    names = [m[0] for m in M.MUTANTS]
    assert len(names) == len(set(names)) >= 20
    assert {m[4] for m in M.MUTANTS} <= set(M.CHILD)
    assert all(m[5] for m in M.MUTANTS)


@pytest.mark.parametrize("mutant", M.MUTANTS, ids=[m[0] for m in M.MUTANTS])
def test_mutant_line_occurs_once_and_edits_one_line(mutant):
    name, source, sound, mutated, _, _ = mutant
    text = (ROOT / M.PKG / source).read_text()
    assert text.count(sound + "\n") == 1, f"{name}: {sound!r}"
    assert "\n" not in sound and "\n" not in mutated and sound != mutated
    edited = text.replace(sound + "\n", mutated + "\n")
    before, after = text.splitlines(), edited.splitlines()
    assert len(before) == len(after)
    assert [i for i, (a, b) in enumerate(zip(before, after)) if a != b] \
        == [before.index(sound)]
