"""Frozen input makers: every input of a run is made from its seed here."""
