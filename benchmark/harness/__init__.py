"""The benchmark's harness: one run of one cell (`cli.main`).

Importing it puts the plain reference (`benchmark/reference/plainref`) on
the import path."""

import os
import sys

_REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "reference")
if _REF not in sys.path:
    sys.path.insert(1, _REF)
