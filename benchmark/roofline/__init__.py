"""Work counts of the port's stages, one module a stage, found by the
stage's name (``roofline/<stage>.py``), with the data-sheet peaks."""
