"""The H100's data-sheet figures (``hw``), the three-term roofline of a
counted program (``analysis``) and the dry run's tables (``report``)."""
