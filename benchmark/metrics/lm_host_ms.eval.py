"""Host milliseconds an LM iteration in the span `ba.eval`, the trial
point: its rotations and translations, kernel B (with the back-substitution,
or PCG's back-substitution before it) and the reduces of its cost and rows.
Its self time a solve over its count, averaged over the program's span
records of the window's last untraced solves (`harness/spans.py`): host
time to issue the work, not device time."""

from harness import spans


def read(layer):
    return spans.phase_ms(layer, "ba.eval")
