"""The general part of the benchmark: it finds every config, cell, entry and
metric by name, so a later change adds files and edits none."""
