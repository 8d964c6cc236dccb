"""Command-line tools of the port: `capture_agent` (a desktop's frames into
the pipeline, by shared-memory ring or TCP).  Nothing is imported here."""
