"""Launchers of the torch port."""
