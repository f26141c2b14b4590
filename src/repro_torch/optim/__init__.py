from .adamw import AdamWConfig, adamw_update, global_norm, init_opt_state, \
    schedule
