"""One driver a kind of traffic, named by a traffic file's ``driver`` key."""
