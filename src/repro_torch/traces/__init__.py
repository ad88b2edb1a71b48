"""Seeded synthetic job traces."""
