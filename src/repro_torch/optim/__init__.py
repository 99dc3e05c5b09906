from .adamw import OptState, adamw_init, adamw_update, clip_by_global_norm
from .schedule import cosine_schedule, linear_warmup_cosine
