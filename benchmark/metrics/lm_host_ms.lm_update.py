"""Host milliseconds an LM iteration in the span `ba.lm_update`: accept or
reject, the LM state, lambda and nu updated by `torch.where`. Its self
time a solve over its count, averaged over the program's span records of
the window's last untraced solves (`harness/spans.py`): host time to issue
the work, not device time."""

from harness import spans


def read(layer):
    return spans.phase_ms(layer, "ba.lm_update")
