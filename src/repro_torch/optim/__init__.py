from .adamw import (OptConfig, apply_updates, clip_by_global_norm,
                    decay_mask, init_state, lr_at, state_specs)
