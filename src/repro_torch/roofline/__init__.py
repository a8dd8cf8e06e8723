"""Roofline terms of the dry-run's traced steps on the H100's peaks."""
