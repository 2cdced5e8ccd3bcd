"""Headless command-line application."""
