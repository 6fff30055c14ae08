"""On the card, at the cells' own sizes: the program's run is correct and
each control, a lower precision the program has a path for, is not
(`python -m pytest benchmark/tests -q -m card`; skips without a card)."""

import pytest

from benchmark import harness

SEED = 2**31 + 99
# (cell, variant, seconds): long enough to finish the cell's longest request
CASES = [("perf20L-offline-b16", "bf16", 1.0),
         ("perf20L-offline-b16", "fast", 1.0),
         ("perf20L-serve-ragged16", "bf16", 14.0),
         ("pytorch16L-train-b4", "tf32", 0.5)]


@pytest.mark.card
@pytest.mark.parametrize("cell,variant,seconds", CASES)
def test_the_control_is_not_correct(card, cell, variant, seconds):
    spec = harness.Spec()
    _, good = harness.run_in_process(spec, cell, SEED, seconds, False, card)
    assert good["correct"] is True, good["compared"]
    _, low = harness.run_in_process(spec, cell, SEED, seconds, False, card,
                                    variant)
    assert low["correct"] is False, low["compared"]
