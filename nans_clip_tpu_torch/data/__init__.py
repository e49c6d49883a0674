"""Data helpers: text preprocessing."""
