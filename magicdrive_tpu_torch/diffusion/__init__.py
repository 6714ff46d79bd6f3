from .schedules import NoiseSchedule
from .samplers import (DDIMCoeffs, UniPCCoeffs, make_ddim_coeffs,
                       make_sampler_coeffs, make_unipc_coeffs)
