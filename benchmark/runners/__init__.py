"""One module per runner, named by a traffic mix's ``runner`` key."""
