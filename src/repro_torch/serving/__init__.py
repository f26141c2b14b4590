"""The serving data plane (the reference's ``repro.serving`` main path)."""
from .dataplane import ServeConfig, build_params, build_tables, \
    make_serve_step, make_synthetic_batch, params_from_numpy
