"""Training on the card: the step (``step.py``) and the synthetic-data loop (``loop.py``)."""
