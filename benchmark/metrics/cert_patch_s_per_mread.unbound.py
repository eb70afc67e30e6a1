"""``cert_patch_s_per_mread``'s reading, in the cells whose rate
has no end-to-end bound (``window_reads_per_s`` stands for it there), so
that its ``moves`` names a metric those cells report."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "cert_patch_s_per_mread.py"))["read"]
