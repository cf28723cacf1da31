"""Framework-wide constants and dtype policy.

Mirrors the role of the reference's ``include/defs.h`` (reference:
/root/reference/include/defs.h:48-101): float pixels, double probability
accumulation, and the MIN_PROB sentinel used to initialise running maxima.
"""

from __future__ import annotations

import os

import numpy as np

# Sentinel used to initialise running log-probability maxima
# (reference defs.h:65 `#define MIN_PROB -999999.`).
MIN_PROB = -999999.0

# Pixel / FFT dtype ("myfloat_t", reference defs.h:66).
FLOAT = np.float32
COMPLEX = np.complex64

# Probability-accumulation dtype ("myprob_t" with BIOEM_PROB_DOUBLE,
# reference defs.h:60). The framework confines float64 to small
# per-(orientation, ctf, image) constants and per-image accumulator state;
# the per-displacement work stays float32.
PROB = np.float64

# Default output filenames (reference defs.h:42-46).
FILE_COORDREAD = "COORDREAD"
FILE_ANG_PROB = "ANG_PROB"
FILE_BESTMAP = "BESTMAP"
FILE_REFINED = "Output_Refined"  # framework extension: --Refine continuous polish
FILE_MAPS_DUMP = "maps.dump"
FILE_MODEL_DUMP = "model.dump"
DEFAULT_OUTPUT_FILE = "Output_Probabilities"

OUTPUT_PRECISION = 4  # reference defs.h:177


def enable_x64() -> None:
    """Enable float64 in JAX unless explicitly disabled via env var.

    The probability accumulation path requires double precision (reference
    defs.h:48 BIOEM_PROB_DOUBLE is on by default). Array-heavy compute stays
    in float32 regardless.
    """
    if os.environ.get("BIOEM_TPU_NO_X64"):
        return
    import jax

    jax.config.update("jax_enable_x64", True)
