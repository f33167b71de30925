"""Geo plane: repair folding across expensive links (repair_fold.py)."""
