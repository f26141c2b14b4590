"""Step functions of the serving path (``launch/steps.py``)."""
