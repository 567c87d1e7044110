"""Frame capture subsystem of the port (the counterpart of
`nu_scaler_tpu/capture`, with the same exports).

Re-creates the reference's real-time capture semantics
(`nu_scaler_core/src/capture/realtime.rs`) on Linux hosts: a producer
thread pushes frames into a bounded ring; consumers drain to the latest frame.
The Windows-only WGC/scrap backends become: X11 screen grab (when a display
exists), file/video sequence sources, and a synthetic generator (always
available — it plays the role `BasicCapture` had in the reference tests,
capture/mod.rs:40-63).
"""

from nu_scaler_tpu_torch.capture.sources import (
    FileSource,
    FrameRing,
    FrameSource,
    SyntheticSource,
    X11Source,
    list_windows,
)
from nu_scaler_tpu_torch.capture.screen import CaptureTarget, ScreenCapture

__all__ = [
    "FrameSource",
    "FrameRing",
    "SyntheticSource",
    "FileSource",
    "X11Source",
    "ScreenCapture",
    "CaptureTarget",
    "list_windows",
]
