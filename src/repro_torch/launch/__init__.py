"""Entry points of the port: ``launch.train`` (the train launcher)."""
