"""Build the native data-pipeline library (g++ -O3 -shared -fPIC).

Invoked lazily by bindings.py on first use, or manually:
    python -m svdd.native.build
"""

from __future__ import annotations

import os
import subprocess

SRC_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(SRC_DIR, 'dna_kernels.cc')
LIB = os.path.join(SRC_DIR, 'libdna_kernels.so')


def build(force: bool = False) -> str:
  if (not force and os.path.exists(LIB)
      and os.path.getmtime(LIB) >= os.path.getmtime(SRC)):
    return LIB
  cmd = ['g++', '-O3', '-march=native', '-shared', '-fPIC',
         '-o', LIB, SRC]
  subprocess.run(cmd, check=True, capture_output=True)
  return LIB


if __name__ == '__main__':
  print(build(force=True))
