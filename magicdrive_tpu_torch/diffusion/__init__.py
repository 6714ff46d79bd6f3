from .schedules import NoiseSchedule
from .samplers import UniPCCoeffs, make_unipc_coeffs
