"""Drivers that offer a traffic mix's load, one file a way of offering it."""
