"""GQA decode attention (one query token, long cache): plain torch version and Hopper kernel."""
