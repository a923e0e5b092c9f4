"""Run chip_smoke.py with torch.profiler blind: every profile's
key_averages() comes back empty, as the profiler's did part-way through
one run of the smoke on an H100 (ROADMAP F18). The smoke must still exit
0 with its last line, each profiler time printed as "not measured".

Run from the root of a checkout, on a machine with a CUDA card:
    python3 tools/blind_profiler_smoke.py
"""
import os
import runpy
import sys

import torch.profiler

torch.profiler.profile.key_averages = lambda self, *args, **kwargs: []
sys.path.insert(0, os.getcwd())
sys.argv = ["chip_smoke.py"]
runpy.run_path("chip_smoke.py", run_name="__main__")
