"""Step functions (``launch/steps.py``), the serving CLI
(``python -m repro_torch.launch.serve``), the training CLI
(``python -m repro_torch.launch.train``) and the dry run
(``python -m repro_torch.launch.dryrun``: every arch x shape cell traced
on a ``meta`` production mesh and counted by ``launch/op_analysis.py``)."""
