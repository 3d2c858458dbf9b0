"""The loops a traffic file can name (`loop`): each drives the measured package one call at a time."""
