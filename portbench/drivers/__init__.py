"""Drivers, one a kind of traffic mix: set-up, window and check of a cell."""
