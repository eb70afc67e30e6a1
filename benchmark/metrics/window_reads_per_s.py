"""reads/s as ``reads_per_s`` reads it (every read aligned and written in the
window, over the window's whole clock), in the cells whose runs spread too
widely on the host's clock for an end-to-end bound: the same number,
reported per layer and bound by nothing."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "reads_per_s.py"))["read"]
