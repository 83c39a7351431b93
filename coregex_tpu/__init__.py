"""coregex_tpu — a regex matching framework for accelerators.

A from-scratch re-design of the capabilities of coregx/coregex (a Go regex
meta-engine) for data-parallel hardware (a GPU): patterns compile ahead of time into dense
artifacts (DFA transition tables over byte classes, NFA bitset masks, literal
prefilter tables) and corpora are scanned with data-parallel JAX/Pallas
kernels, sharded across device meshes for scale-out.
"""

__version__ = "0.1.0"

from .api import (Regex, compile, compile_posix, must_compile, quote_meta,
                  match, match_string)

__all__ = ["Regex", "compile", "compile_posix", "must_compile", "quote_meta",
           "match", "match_string", "__version__"]
