"""Aggregation protocol: client, server, round helpers and transport."""
