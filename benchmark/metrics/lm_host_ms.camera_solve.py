"""Host milliseconds an LM iteration in the span `ba.camera_solve`, the
camera system's solution: the Cholesky solve or PCG, and the fixed
cameras' step set to zero. Its self time a solve over its count, averaged
over the program's span records of the window's last untraced solves
(`harness/spans.py`): host time to issue the work, not device time."""

from harness import spans


def read(layer):
    return spans.phase_ms(layer, "ba.camera_solve")
