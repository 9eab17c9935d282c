"""The plain reference the benchmark holds the port to: ``scale`` and the
frozen planner, formats and tables it needs."""
