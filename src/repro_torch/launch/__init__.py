"""Step functions of the serving path (``launch/steps.py``) and the
serving CLI (``python -m repro_torch.launch.serve``)."""
