"""Runners of the port's entries, one file a kind of request, named by a
traffic mix's ``"runner"``."""
