"""Services around the pipeline: `control`, the web control panel that
spawns and stops the port's CLI.  Nothing is imported here."""
