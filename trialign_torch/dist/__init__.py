"""Batches of independent triplets (the port of ``trialign/dist``); the
multi-device parts wait for their slice."""
