"""Payload codecs of the port: batch staging and response construction."""
