"""The serving data plane (the reference's ``repro.serving`` main path)
and its request-level frontend."""
from .dataplane import ServeConfig, build_fleet, build_params, \
    build_tables, make_request_batch, make_request_rows, \
    make_request_windows, make_serve_step, make_synthetic_batch, \
    params_from_numpy
from .frontend import ArrivalProfile, DynamicBatcher, FrontendConfig, \
    OpenLoopDriver, Request, RequestQueue, ServingFrontend, \
    bursty_onoff_gaps, poisson_gaps
