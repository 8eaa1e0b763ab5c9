"""Training code of the port beyond the step loop: the event-driven
``async`` backend (``async_trainer``)."""
