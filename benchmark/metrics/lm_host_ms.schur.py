"""Host milliseconds an LM iteration in the span `ba.schur`, which forms
the camera system: kernel C; or kernel D, Pf, Q Q^T and the damped U; or
K5; or PCG's damped U and V^-1. Its self time a solve over its count,
averaged over the program's span records of the window's last untraced
solves (`harness/spans.py`): host time to issue the work, not device
time."""

from harness import spans


def read(layer):
    return spans.phase_ms(layer, "ba.schur")
