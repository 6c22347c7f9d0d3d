"""Prefill attention (causal or not, GQA): the route to the plain version or the Hopper kernel."""
